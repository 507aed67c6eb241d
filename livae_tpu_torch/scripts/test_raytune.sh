#!/usr/bin/env bash
# Smoke test: 1 trial x 1 epoch of the port's sweep on synthetic data
# (scripts/test_raytune.sh's counterpart; a sweep integration test without a
# cluster). Extra arguments (--cpu, for one) go to the sweep CLI.
set -euo pipefail
cd "$(dirname "$0")/../.."
python -m livae_tpu_torch.scripts.train_rvae_raytune \
  --synthetic 1 --synthetic-size 512 \
  --patch-size 64 --padding 16 --batch-sizes 64 \
  --num-samples 1 --epochs 1 --scheduler none \
  --experiment-name smoke_test \
  --save-best-config "${TMPDIR:-/tmp}/smoke_best_config.json" "$@"
echo "Sweep smoke test passed"
