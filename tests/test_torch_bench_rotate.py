"""`python -m livae_tpu_torch.bench_rotate` on the CPU, at a tiny size.

It prints one line per measurement and, last, the dict of us per patch under
the keys scripts/bench_rotate.py prints (the JAX script needs the TPU, so its
keys are rebuilt here from its naming with JAX's own dtype names).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent


def test_bench_rotate_prints_the_jax_key_set():
    args = ["--cpu", "--batch", "2", "--reps", "1", "--canvases", "32", "--rotations", "16,4"]
    out = subprocess.run([sys.executable, "-m", "livae_tpu_torch.bench_rotate", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    results = ast.literal_eval(lines[-1])
    names = [dt.__name__ for dt in (jnp.bfloat16, jnp.float32)]
    want = [f"shear1_32_{n}" for n in names]
    for n in names:
        want += [f"rot_fwd_16_m4_{n}", f"rot_grad_16_m4_{n}"]
    assert list(results) == want
    assert all(v > 0 for v in results.values())
    assert len(lines) == len(want) + 1
    assert all("ms/call" in line and "us/patch" in line for line in lines[:-1])
