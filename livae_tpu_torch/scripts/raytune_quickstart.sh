#!/usr/bin/env bash
# Quickstart: a 5-trial ASHA demo sweep with the port (scripts/raytune_quickstart.sh's
# counterpart), then its analysis.
set -euo pipefail
cd "$(dirname "$0")/../.."
python -m livae_tpu_torch.scripts.train_rvae_raytune \
  --synthetic 1 --synthetic-size 1024 \
  --patch-size 128 --padding 32 --batch-sizes 256 \
  --num-samples 5 --epochs 6 --grace-period 2 --scheduler asha \
  --experiment-name quickstart
python -m livae_tpu_torch.scripts.analyze_raytune_results --results-dir ray_results/quickstart --plots
