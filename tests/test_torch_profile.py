"""The port's profilers on the CPU at a small size: `profile_step --cpu` on
each `--path` (its first-call line, then each phase's operators by self
time), and `scripts.profile_components --cpu` (every stage of the JAX
script, by its name, then the JSON)."""

import json
import re

import pytest
import torch

from livae_tpu_torch import profile_step
from livae_tpu_torch.scripts import profile_components

SMALL = ["--cpu", "--patch", "32", "--padding", "8", "--batch", "16", "--latent-dim", "8",
         "--frame-size", "512", "--steps", "1", "--top", "3"]
PHASES = {"paired": ["train", "eval", "encode"], "vae": ["train", "eval"], "patch": ["train"],
          "encode": ["encode"], "stacked": ["train"]}
# scripts/profile_components.py's stages, in its order
STAGES = ["extract_paired", "x_crop_rois", "x_crop_resample", "x_rot_copy_only",
          "x_normalize_only", "encoder_fwd", "full_fwd", "decoder_fwd", "inverse_rotate",
          "paired_loss_fwd", "loss_grad", "grad_no_canon", "grad_no_cycle", "full_train_step"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", list(PHASES))
def test_profile_step_path(capsys, path):
    out = profile_step.main([*SMALL, "--path", path])
    printed = capsys.readouterr().out
    lines = printed.splitlines()
    assert lines[0] == "cpu"
    first = next(i for i, ln in enumerate(lines) if ln.startswith("== "))
    assert lines[first].startswith(f"== {path} first calls in this process: ")
    for phase in PHASES[path]:
        assert f"{phase} " in lines[first]
        assert re.search(rf"^== {path} {phase} \(.*\): wall [0-9.]+ ms, \d+ operators",
                         printed, re.M), phase
    assert set(out[path]["first_call_ms"]) == set(out[path]["wall_ms"]) == set(PHASES[path])
    assert all(v > 0 for v in out[path]["wall_ms"].values())
    assert "aten::" in printed  # the operators by self time


def test_profile_step_default_path_and_trace(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    out = profile_step.main([*SMALL, "--trace", str(trace)])
    assert list(out) == ["paired"]
    assert json.loads(trace.read_text())["traceEvents"]
    capsys.readouterr()


def test_profile_components(capsys):
    out = profile_components.main(["--cpu", "--batch", "8", "--patch", "32", "--reps", "2"])
    printed = capsys.readouterr().out
    assert printed.splitlines()[0] == "cpu"
    for name in STAGES:
        assert re.search(rf"^\s*{name}: +[0-9.]+ patches/sec$", printed, re.M), name
    blob = json.loads(printed[printed.index("{"):])
    assert blob == out
    assert list(blob["patches_per_sec"]) == STAGES == list(blob["us_per_patch"])
    for name in STAGES:
        assert blob["patches_per_sec"][name] > 0
        assert blob["us_per_patch"][name] == pytest.approx(1e6 / blob["patches_per_sec"][name],
                                                           rel=1e-2)
