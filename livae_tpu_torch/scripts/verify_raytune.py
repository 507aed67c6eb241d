#!/usr/bin/env python
"""Environment check for the port's sweep (port of the root verify_raytune.py).

Run as  python -m livae_tpu_torch.scripts.verify_raytune [--root DIR]

The JAX file's five checks, on the port's scripts: the sweep scripts
compile; `livae_tpu_torch.sweep` imports (ray is optional: the native engine
runs without it); `.h5` data under DIR/data, or the synthetic fallback;
DIR/checkpoints and DIR/ray_results exist (made if missing); the sweep's
argparser builds and parses. DIR defaults to the current directory. Prints a
line per check and the count; exits 1 if any failed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

SCRIPTS = Path(__file__).resolve().parent
SWEEP_SCRIPTS = ("train_rvae_raytune.py", "train_rvae_with_best.py",
                 "analyze_raytune_results.py")

CHECKS: list[tuple[str, bool, str]] = []


def check(name: str, ok: bool, detail: str = "") -> None:
    CHECKS.append((name, ok, detail))
    print(f"  [{'OK' if ok else 'FAIL'}] {name}" + (f" — {detail}" if detail else ""))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Check the sweep's environment")
    parser.add_argument("--root", type=Path, default=Path("."),
                        help="Where data/, checkpoints/ and ray_results/ live")
    root = parser.parse_args(argv).root
    CHECKS.clear()

    print("1. Syntax compile of sweep scripts")
    for script in SWEEP_SCRIPTS:
        name = f"livae_tpu_torch/scripts/{script}"
        try:
            path = SCRIPTS / script
            compile(path.read_text(), str(path), "exec")  # writes no .pyc into the package
            check(f"compile {name}", True)
        except Exception as e:  # noqa: BLE001 - every failure is a failed check
            check(f"compile {name}", False, str(e))

    print("2. Imports")
    try:
        from livae_tpu_torch.sweep import ASHAScheduler, PBTScheduler, run_search  # noqa: F401

        check("livae_tpu_torch.sweep imports", True)
    except Exception as e:  # noqa: BLE001
        check("livae_tpu_torch.sweep imports", False, str(e))
    try:
        import ray  # noqa: F401

        check("ray available (optional)", True)
    except ImportError:
        check("ray available (optional)", True, "absent; native engine will be used")

    print("3. Data")
    h5 = sorted((root / "data").glob("*.h5")) if (root / "data").exists() else []
    check("h5 data or synthetic fallback", True,
          f"{len(h5)} files found" if h5 else "none found; use --synthetic N")

    print("4. Directories")
    for d in ("checkpoints", "ray_results"):
        (root / d).mkdir(parents=True, exist_ok=True)
        check(f"{d}/ writable", (root / d).is_dir())

    print("5. Argparser")
    try:
        from livae_tpu_torch.scripts import train_rvae_raytune

        args = train_rvae_raytune.build_argparser().parse_args(
            ["--num-samples", "1", "--epochs", "1", "--synthetic", "1"])
        check("argparser builds and parses", args.num_samples == 1)
    except Exception as e:  # noqa: BLE001
        check("argparser builds and parses", False, str(e))

    failed = [c for c in CHECKS if not c[1]]
    print(f"\n{len(CHECKS) - len(failed)}/{len(CHECKS)} checks passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
