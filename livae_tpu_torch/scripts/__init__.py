"""Training entry points: `python -m livae_tpu_torch.scripts.train_rvae` and
`python -m livae_tpu_torch.scripts.train_vae`."""
