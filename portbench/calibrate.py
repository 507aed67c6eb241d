"""Readings for setting a cell's limits, many seeds in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [<n> ...]
        [--sides program control half_batch|altered] [--out FILE]

For each seed it builds the cell as a run does (frames, site table, weights,
the first calls of the timed path, which for a training cell are the three
steps the reference follows and for the analysis cell one pass), frees the
program's state and prints one JSON line per side: "program" (what the
timed path produced), "control" (the plain reference at the precision below
the configuration's, in the program's place) and a planted fault: for a
training cell "half_batch" (the reference in the program's place with each
batch halved), for the analysis "altered" (the program's answers with one
site in a hundred given its neighbour's mu). No window is measured. Needs
the CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "control"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    os.environ["LIVAE_TORCH_BUILD_DIR"] = str(root / "livae_tpu_torch" / "_build")
    import torch

    from . import spec, trace

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = spec.workload(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    loop = spec.loop(traffic["loop"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = loop.Run(cfg, traffic, seed, device, trace.Spans())
        run.setup()
        evidence = run.close()
        t1 = time.perf_counter()
        for side, r in loop.compare(evidence, cfg, traffic, device, args.sides).items():
            line = json.dumps({"workload": args.workload, "seed": seed, "side": side, **r,
                               "setup_s": t1 - t0, "compare_s": time.perf_counter() - t1})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
