"""The model bindings: one module a model, `models/<model>.py`, named by a
configuration's "model". A binding is all the benchmark knows of a model;
the loops, the readers, the counts and the reference's drive hold no
model's name. It imports the program (`livae_tpu_torch`) only inside its
functions, which the loops call inside their set-up spans, and may import
the plain reference (`portbench/reference/`) at the top.

    PAIRED               bool: a training batch is extracted as a pair (the
                         program's paired dataset; the reference's extraction
                         gives (x, x_rot, angle)), else as one patch
    LATENT_BIASES        {"mu": key, "logvar": key}: the state-dict keys of the
                         biases the analysis' latent gaps subtract (a model
                         an analysis cell runs; so too analysis_model and
                         reference_stats)
    KERNELS              optional {operation: [kernel-name patterns]}, merged
                         with counts/kernel_map.json

    Program side:
    train_model(cfg, device) -> nn.Module
    train_step(model, optimizer, scheduler, augment, cfg, **kw) -> (step, eval)
                         the program's fused train step and eval; kw are the
                         site-table arguments (patch_size, padding, margin,
                         normalize, device)
    draws(cfg, B, generator, device) -> (draws, eps)
                         one step's augmentation draws and noise, drawn from
                         the epoch's generator on the device
    analysis_model(cfg, device) -> (nn.Module, is_rvae)
                         the model as the analysis scripts build it, and
                         `collect_stats`' flag for it

    Reference side:
    reference_loss(params, batch, eps, precision, loss_cfg) -> (loss, {term: value})
                         batch: what the reference's extraction gives
    reference_stats(params, x, eps, precision) -> {name: [B, ...] tensor}
                         one analysis batch: "mu", "logvar", "rec_err", and
                         "theta" and "cond" (the angle's condition number)
                         where the model predicts an angle

    Counts (two FLOPs per multiply-add; bytes as counts/ops.py counts them):
    forward_flops(S, latent), train_flops(S, latent) -> int   one patch
    kernel_ops(phase, cfg, padding, B, elem) -> [(operation, bytes)]
                         the hand-written operations of one batch of B at
                         `elem` bytes an element; phase "train" (a train
                         step), "eval" (an eval batch) or "encode" (an
                         analysis batch)
"""
