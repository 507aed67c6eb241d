#!/usr/bin/env bash
# Batch-queue wrapper for the port's sweep (scripts/jank.sh's counterpart):
# a SLURM submission stub for one GPU node; adapt the directives to your
# cluster. Arguments go to the sweep CLI.
#SBATCH --job-name=livae-sweep
#SBATCH --gres=gpu:1
#SBATCH --time=12:00:00
set -euo pipefail
cd "$(dirname "$0")/../.."
python -m livae_tpu_torch.scripts.train_rvae_raytune "$@"
