"""The port's bench (python -m livae_tpu_torch.bench) on the CPU with its sizes
cut: one JSON line on stdout with the keys of the repository root's bench.py,
the dataset build on stderr, and a failing exit code after an error."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--cpu", "--no-amp", "--frame-size", "512", "--patch", "32", "--padding", "8",
         "--latent", "8", "--batch", "16", "--steps-per-epoch", "2", "--epochs", "1",
         "--val-batches", "1", "--encode-steps", "2"]


def _root_bench_keys():
    """The keys of the `result` dict literal and its `detail` in bench.py."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result"
                and isinstance(node.value, ast.Dict)):
            keys = [k.value for k in node.value.keys]
            detail = node.value.values[keys.index("detail")]
            return keys, [k.value for k in detail.keys]
    raise AssertionError("bench.py has no result dict")


def _bench(*args):
    # one thread: the test workers share the machine's cores
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "livae_tpu_torch.bench", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)


def test_bench_prints_one_json_line_with_bench_py_keys():
    out = _bench(*SMALL)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    result = json.loads(lines[0])
    keys, detail_keys = _root_bench_keys()
    assert list(result) == keys and list(result["detail"]) == detail_keys
    assert result["metric"] == "rvae_train_encode_patches_per_sec_per_chip_sustained"
    assert result["unit"] == "patches/sec" and result["value"] > 0
    d = result["detail"]
    assert d["train_patches_per_sec_sustained"] > 0 and d["encode_patches_per_sec"] > 0
    assert (d["epochs_timed"], d["batch"], d["patch"]) == (1, 16, 32)
    assert d["device"] == "cpu" and "6.8" in d["baseline"] and "TPU" not in d["baseline"]
    assert "Adaptive lattice" in out.stderr  # the dataset build goes to stderr


def test_bench_defaults_are_the_protocol():
    from livae_tpu_torch import bench

    a = bench.build_argparser().parse_args([])
    assert (a.frame_size, a.patch, a.padding, a.latent, a.batch) == (1024, 128, 32, 16, 512)
    assert (a.steps_per_epoch, a.epochs, a.val_batches, a.encode_steps) == (12, 2, 2, 12)
    assert not a.cpu and not a.no_amp


def test_bench_failure_prints_the_error_line_and_exits_nonzero():
    out = _bench(*SMALL, "--patch", "30")  # the decoder's 16x upsample cannot give 30
    assert out.returncode == 2
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["value"] == 0.0 and "error" in result
    assert "Traceback" in out.stderr
