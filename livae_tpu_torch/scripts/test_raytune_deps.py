#!/usr/bin/env python
"""Check the sweep's dependencies (port of scripts/test_raytune_deps.py).

Run as  python -m livae_tpu_torch.scripts.test_raytune_deps

The port sweeps with its native engine (livae_tpu_torch.sweep): the check
imports its names and exits 0, or 1 when they do not import. It also says
whether Ray and hyperopt are installed; neither is needed (the native engine
is used either way).
"""

import sys


def main() -> int:
    try:
        from livae_tpu_torch.sweep import (  # noqa: F401
            ASHAScheduler,
            PBTScheduler,
            TPESearcher,
            choice,
            get_best_result,
            loguniform,
            run_search,
        )

        print("OK: native sweep engine imports (livae_tpu_torch.sweep)")
    except ImportError as e:
        print(f"FAIL: native sweep engine import error: {e}")
        print("Run from the repo root (or pip install -e .)")
        return 1

    for optional in ("ray", "hyperopt"):
        try:
            mod = __import__(optional)
            ver = getattr(mod, "__version__", "?")
            print(f"OK: optional {optional} present (version {ver})")
        except ImportError:
            print(f"note: optional {optional} not installed (native engine is used)")

    print("\nAll sweep dependencies are available.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
