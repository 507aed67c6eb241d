"""Run one cell of the port's benchmark once, on the CUDA device, and print
its result as the last line of standard output.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics from a traced window after the measured one. Either way the run
ends by comparing what its timed path produced with the plain reference
(portbench/reference) and prints each number compared beside its limit, as
the last lines of standard error and under "checks" in the result.
Exits 1, with no result, where there is no CUDA device or too few, and where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.time()  # the set-up time counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "livae_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel libraries live in the checkout, at a fixed path
    root = Path(__file__).resolve().parent.parent
    os.environ["LIVAE_TORCH_BUILD_DIR"] = str(root / "livae_tpu_torch" / "_build")
    import torch

    from . import harness, spec

    cell = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
