"""Toy trainables for the sweep-engine tests. Standard library only (no numpy,
torch or jax), so a spawned trial process starts quickly; the process
executor pickles them by module path."""

import os


def quadratic(config, report):
    """loss = (x - 3)^2 + 10 / epoch + k / 100: ASHA and TPE have a clear order."""
    for epoch in range(1, config["epochs"] + 1):
        loss = (config["x"] - 3.0) ** 2 + 10.0 / epoch + config["k"] / 100.0
        report(epoch=epoch, loss=loss, val_loss=loss + config["lr"])


def population(config, report):
    """A weight w moves toward 3 at rate lr each epoch; the checkpoint is the
    weight. On a PBT exploit the trial takes the donor's weight and config
    and records where it came from in its next reports."""
    w, lr, source = config["x"], config["lr"], ""
    for epoch in range(1, config["epochs"] + 1):
        w += lr * (3.0 - w)
        out = report(epoch=epoch, loss=(w - 3.0) ** 2, val_loss=(w - 3.0) ** 2,
                     source=source, checkpoint={"w": w, "trial_x": config["x"]})
        if isinstance(out, dict):
            w, lr = out["checkpoint"]["w"], out["config"]["lr"]
            source = f"x={out['checkpoint']['trial_x']!r}"


def failing(config, report):
    """Fails on its first report when x > 4 (a trial error the engine tolerates)."""
    report(epoch=1, loss=config["x"])
    if config["x"] > 4.0:
        raise RuntimeError("toy failure")
    report(epoch=2, loss=config["x"] / 2)


def in_process(config, report):
    """Reports its process, its slot's CUDA_VISIBLE_DEVICES and trial id."""
    report(epoch=1, loss=config["x"], pid=os.getpid(),
           cuda_visible=os.environ.get("CUDA_VISIBLE_DEVICES", ""),
           trial_env_id=os.environ.get("LIVAE_TRIAL_ID", ""))
