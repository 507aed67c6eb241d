"""The port's sweep environment check (livae_tpu_torch.scripts.verify_raytune)
and its shell wrappers."""

import subprocess
import sys
from pathlib import Path

import pytest

from livae_tpu_torch.scripts import verify_raytune

REPO = Path(__file__).resolve().parent.parent
WRAPPERS = REPO / "livae_tpu_torch" / "scripts"


def test_all_five_checks_pass_under_a_root(tmp_path, capsys):
    assert verify_raytune.main(["--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for header in ("1. Syntax compile of sweep scripts", "2. Imports", "3. Data",
                   "4. Directories", "5. Argparser"):
        assert header in out
    assert "[FAIL]" not in out and "\n9/9 checks passed\n" in out
    assert "livae_tpu_torch/scripts/train_rvae_raytune.py" in out
    assert "none found; use --synthetic N" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoints", "ray_results"]


def test_finds_data_and_fails_a_broken_script(tmp_path, monkeypatch, capsys):
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "frame.h5").write_bytes(b"")
    broken = tmp_path / "scripts"
    broken.mkdir()
    for name in verify_raytune.SWEEP_SCRIPTS:
        (broken / name).write_text("def (:\n" if name == "train_rvae_with_best.py" else "x = 1\n")
    monkeypatch.setattr(verify_raytune, "SCRIPTS", broken)
    assert verify_raytune.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "1 files found" in out
    assert "[FAIL] compile livae_tpu_torch/scripts/train_rvae_with_best.py" in out
    assert "\n8/9 checks passed\n" in out


def test_runs_as_a_module(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "livae_tpu_torch.scripts.verify_raytune",
                           "--root", str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.rstrip().endswith("9/9 checks passed")


@pytest.mark.parametrize("name,entry", [
    ("jank.sh", "train_rvae_raytune"), ("raytune_quickstart.sh", "train_rvae_raytune"),
    ("test_raytune.sh", "train_rvae_raytune")])
def test_shell_wrappers_call_the_port(name, entry):
    path = WRAPPERS / name
    assert subprocess.run(["bash", "-n", str(path)], capture_output=True).returncode == 0
    text = path.read_text()
    assert f"python -m livae_tpu_torch.scripts.{entry}" in text
    assert "scripts/train_rvae_raytune.py" not in text  # not the JAX CLI
    assert path.stat().st_mode & 0o111
