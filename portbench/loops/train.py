"""Training epochs back to back, in a closed loop, as the training entry
points run them (`scripts/train_rvae.py`, `scripts/train_vae.py`).

Each epoch shuffles the train split into steps of `batch_size` sites. Each
step is one call of the program's fused train step (the model's binding
builds it: `make_fused_rvae_train_step`, `make_fused_vae_train_step`), with a
CUDA event before and after it, its augmentation draws and noise drawn by the
benchmark on the device from the seed (the binding's `draws`). After the
steps the epoch's train metrics are read on the host at once; then the
binding's fused eval runs over the validation split through
`evaluate_fused`, as the entry points read it.

Set-up builds one training object (model, optimizer, schedule, step) and
drives its first three steps, the first three of epoch 0, through the same
call; the window goes on from the fourth. The reference follows those three
steps from the same weights, sites, draws and noise.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from .. import spec, trace as T
from ..reference import drive, sites as ref_sites
from .common import (StepTimer, build_frames, gap, generator, init_device, make_weights,
                     percentile, prebuild, split, sync)

CHECKED_STEPS = 3


class Run:
    """One training cell's program side: set-up, window, traced segment and
    the evidence for the reference."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans: T.Spans):
        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        self.binding = spec.binding(cfg["model"])
        self.B = traffic["batch_size"]

    # --- set-up ---

    def setup(self) -> None:
        with self.spans("program_import"):
            from livae_tpu_torch.data.datasets import (AdaptiveLatticeDataset,
                                                       PairedAdaptiveLatticeDataset)
            from livae_tpu_torch.data.pipeline import AugmentConfig
            from livae_tpu_torch.train import engine, state

        cfg, dev = self.cfg, self.device
        with self.spans("cuda_init"):
            init_device(dev)
        with self.spans("kernels"):
            prebuild(dev)
        with self.spans("frames"):
            self.frames = build_frames(self.seed, self.traffic, dev)
        augment = AugmentConfig(**cfg["augment"])
        make_ds = PairedAdaptiveLatticeDataset if self.binding.PAIRED else AdaptiveLatticeDataset
        with self.spans("dataset_build"):
            ds = make_ds(self.frames, patch_size=cfg["patch_size"], padding=cfg["padding"],
                         transform=augment, normalize=cfg["normalize"], device=dev)
        self.n_sites = len(ds)
        self.train_idx, self.val_idx = split(self.n_sites, self.traffic["val_split"], self.seed)
        self.site_table = ds.device_site_table[:3]
        self.train_dev = torch.as_tensor(self.train_idx, device=dev)
        self.steps_per_epoch = len(self.train_idx) // self.B
        if self.steps_per_epoch <= CHECKED_STEPS:
            raise ValueError(f"{len(self.train_idx)} train sites give {self.steps_per_epoch} "
                             f"steps of {self.B}; the cell needs more than {CHECKED_STEPS}")

        with self.spans("model"):
            self._build(ds, augment, engine, state)
        with self.spans("first_calls"):
            self.checked = self._checked_steps()
            self._eval(generator(self.seed, "val", "warm-up", device=dev))

    def _build(self, ds, augment, engine, state) -> None:
        """Model, weights, optimizer, schedule, train step and eval, as the entry points build them."""
        cfg, dev = self.cfg, self.device
        model = self.binding.train_model(cfg, dev)
        self.w0 = make_weights(model, self.seed, cfg["init"], dev)
        model.load_state_dict(self.w0)

        opt, total = cfg["optimizer"], cfg["schedule"]["epochs"] * self.steps_per_epoch
        if cfg["schedule"]["name"] == "cosine":
            lr = state.cosine_annealing(opt["lr"], total)
        else:
            lr = state.cosine_warm_restarts(opt["lr"], cfg["schedule"]["t0_epochs"] * self.steps_per_epoch,
                                            cfg["schedule"]["t_mult"], total_steps=total)
        self.lr = lr
        optimizer = state.make_optimizer(model, lr, optimizer=opt["name"],
                                         weight_decay=opt["weight_decay"])
        scheduler = state.make_schedule(optimizer, lr)
        self.step, self.eval_fn = self.binding.train_step(
            model, optimizer, scheduler, augment, cfg, patch_size=cfg["patch_size"],
            padding=cfg["padding"], margin=ds._margin, normalize=cfg["normalize"], device=dev)
        self.model, self.optimizer, self.ds = model, optimizer, ds
        self.engine = engine
        self.epoch = -1
        self._next_epoch()

    def _next_epoch(self) -> None:
        self.epoch += 1
        self.gen = generator(self.seed, "epoch", self.epoch, device=self.device)
        perm = torch.randperm(len(self.train_idx), generator=self.gen, device=self.device)
        S = self.steps_per_epoch
        self.idx = self.train_dev[perm[:S * self.B]].reshape(S, self.B)
        self.pos = 0

    def _call(self):
        """The next step of the epoch: (metrics, draws, eps, site indices)."""
        d, e = self.binding.draws(self.cfg, self.B, self.gen, self.device)
        idx = self.idx[self.pos:self.pos + 1]
        loss = self.cfg["loss"]
        m = self.step(*self.site_table, idx, self.gen, loss["beta"], loss["gamma"],
                      draws=[d], eps=[e])
        self.pos += 1
        return m, d, e, idx[0]

    def _checked_steps(self) -> dict:
        """The first three steps: their losses, the first gradient as the
        optimizer holds it after one step, and every leaf's change after three."""
        params = dict(self.model.named_parameters())
        beta1 = self.cfg["optimizer"]["betas"][0]
        steps, losses = [], []
        for t in range(CHECKED_STEPS):
            m, d, e, idx = self._call()
            losses.append(float(m["loss"]))
            steps.append({"idx": idx.clone(), "draws": {k: v.clone() for k, v in vars(d).items()},
                          "eps": e.clone()})
            if t == 0:  # a leaf the optimizer holds no state for got no gradient
                terms = {k: float(v) for k, v in m.items()}  # the reference names its terms
                first = {k: self.optimizer.state[p]["exp_avg"] / (1 - beta1)
                         if "exp_avg" in self.optimizer.state[p] else torch.zeros_like(p)
                         for k, p in params.items()}
                grad = {k: g.norm().item() for k, g in first.items()}
        change = {k: (p.detach() - self.w0[k]).norm().item() for k, p in params.items()}
        return {"steps": steps, "losses": losses, "terms": terms, "grad_norms": grad,
                "grads": first, "change_norms": change}

    def _eval(self, gen) -> dict:
        loss = self.cfg["loss"]
        return self.engine.evaluate_fused(
            self.eval_fn, self.ds.device_site_table, self.val_idx, min(self.B, len(self.val_idx)),
            gen, beta=loss["beta"], gamma=loss["gamma"])

    def _read(self, metrics: list[dict]) -> bool:
        """The epoch's train metrics, read on the host at once; True if finite."""
        names = list(metrics[0])
        means = torch.stack([torch.stack([m[k] for k in names]) for m in metrics]).mean(0)
        host = self.engine.metrics_to_host(dict(zip(names, means)))
        return all(np.isfinite(v).all() for v in host.values())

    # --- window ---

    def window(self, seconds: float) -> dict:
        dev, B = self.device, self.B
        timer, failed = StepTimer(dev), 0
        sync(dev)
        t0 = time.perf_counter()
        deadline, stop = t0 + seconds, False
        while not stop:
            metrics = []
            while self.pos < self.steps_per_epoch and not stop:
                metrics.append(timer(lambda: self._call()[0]))
                stop = time.perf_counter() >= deadline
            if metrics and not self._read(metrics):
                failed += len(metrics)
            if not stop:
                self._eval(generator(self.seed, "val", self.epoch, device=dev))
                self._next_epoch()
        sync(dev)
        wall = time.perf_counter() - t0
        step_ms = timer.ms()
        self.window_info = {"steps": len(step_ms), "seconds": wall, "batch": B,
                            "epochs": self.epoch + 1}
        print(f"window: {len(step_ms)} train steps of {B} in {wall:.3f} s over "
              f"{self.epoch + 1} epochs ({self.n_sites} sites, {len(self.train_idx)} train, "
              f"{self.steps_per_epoch} steps an epoch); step ms median "
              f"{percentile(step_ms, 50):.3f}, p95 of {len(step_ms)} samples "
              f"{percentile(step_ms, 95):.3f}", flush=True)
        return {"attempted": len(step_ms), "failed": failed, "metrics": {
            "train_patches_per_s": len(step_ms) * B / wall,
            "train_step_ms_p95": percentile(step_ms, 95)}}

    def traced(self) -> T.Trace:
        """A short window under the profiler: steps of a fresh epoch, the
        drain before the host read, the host read and the eval."""
        self._next_epoch()
        n = min(self.traffic["trace_steps"], self.steps_per_epoch)
        out = []

        def segment():
            for _ in range(n):
                with self.spans("step"):
                    out.append(self._call()[0])
            with self.spans("drain"):
                sync(self.device)
            with self.spans("host_read"):
                self._read(out)
            with self.spans("eval"):
                self._eval(generator(self.seed, "val", "traced", device=self.device))

        tr = T.capture(segment, self.spans, self.device)
        n_val = len(self.val_idx)
        bs = min(self.B, n_val)
        tr.info |= {"steps": n, "batch": self.B,
                   "eval_batches": [bs] * (n_val // bs) + ([n_val % bs] if n_val % bs else [])}
        return tr

    def close(self) -> dict:
        """Free the program's state; return the evidence for the reference."""
        ev = {"frames": self.frames, "train_idx": self.train_idx, "n_sites": self.n_sites,
              "w0": {k: v.detach().clone() for k, v in self.w0.items()}, **self.checked,
              "lrs": [self.lr(t) for t in range(CHECKED_STEPS)]}
        del self.model, self.optimizer, self.step, self.eval_fn, self.ds, self.site_table
        torch.cuda.empty_cache()
        return ev


def _leaf_gaps(got: dict, ref: dict, key: str, leaves: list[str]) -> dict:
    """Per leaf, the gap of its norm over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    med = float(np.median([ref[key][k] for k in leaves]))
    return {k: gap(got[key][k], ref[key][k], max(ref[key][k], med)) for k in leaves}


def _difference_gaps(got: dict, ref: dict, leaves: list[str]) -> dict:
    """Per leaf, the norm of the difference of the first gradients, the
    program's over the one factor the global clip puts on every leaf
    (estimated as the median over leaves of the ratio of the two sides'
    norms), against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    gn, rn = got["grad_norms"], ref["grad_norms"]
    scale = float(np.median([gn[k] / rn[k] for k in leaves if rn[k] > 0]))
    scale = scale if scale > 0 else 1.0
    med = float(np.median([rn[k] for k in leaves]))
    return {k: (got["grads"][k].double() / scale - ref["grads"][k].double()).norm().item()
            / max(rn[k], med) for k in leaves}


def program_readings(got: dict, ref: dict) -> dict:
    """The readings of one side against the reference: the first step's loss
    gap, its terms' largest gap and the loss's largest over the three steps;
    the first gradient's difference (`_difference_gaps`) over the leaves at
    the median and at the 70th percentile, and its norm's gap at the worst
    leaf; the change's gap at the worst kept leaf. A leaf is
    kept for the change where the reference's first gradient is at least a
    thousandth of the median leaf's (leaves with none move by round-off
    alone under Adam)."""
    leaves = list(ref["grad_norms"])
    med_g = float(np.median([ref["grad_norms"][k] for k in leaves]))
    kept = [k for k in leaves if ref["grad_norms"][k] >= 1e-3 * med_g]
    changes = _leaf_gaps(got, ref, "change_norms", kept)
    losses = [gap(a, b, abs(b)) for a, b in zip(got["losses"], ref["losses"])]
    terms = max(gap(got["terms"][k], v, abs(v)) for k, v in ref["terms"].items())
    diffs = list(_difference_gaps(got, ref, leaves).values())
    return {"loss_gap_step1": losses[0], "terms_gap_step1": terms,
            "grad_diff_median": float(np.median(diffs)),
            "grad_diff_q70": float(np.quantile(diffs, 0.7)),
            "change_gap": max(changes.values()), "loss_gap": max(losses),
            "grad_gap": max(_leaf_gaps(got, ref, "grad_norms", leaves).values())}


def detail(got: dict, ref: dict) -> dict:
    """Each step's loss and term gaps, every leaf's gradient difference, and
    both sides' leaf norms: the look behind the readings."""
    leaves = list(ref["grad_norms"])
    return {"loss_gaps": [gap(a, b, abs(b)) for a, b in zip(got["losses"], ref["losses"])],
            "term_gaps": {k: gap(got["terms"][k], v, abs(v)) for k, v in ref["terms"].items()},
            "grad_difference": _difference_gaps(got, ref, leaves),
            "grad_norms": [got["grad_norms"], ref["grad_norms"]],
            "change_norms": [got["change_norms"], ref["change_norms"]]}


def reference_inputs(ev: dict, cfg: dict, device) -> tuple:
    """The reference's own frames and site table, and the checked steps'
    inputs in its terms: (frames, steps, site-count gap)."""
    frames, img_idx, coords, _ = ref_sites.build(ev["frames"], cfg["patch_size"], cfg["padding"])
    frames = torch.as_tensor(frames, device=device)
    img_idx = torch.as_tensor(img_idx, device=device)
    coords = torch.as_tensor(coords, device=device)
    count_gap = abs(len(coords) - ev["n_sites"])
    steps = []
    if count_gap == 0:
        for s in ev["steps"]:
            i = s["idx"].to(device)
            steps.append({"img_idx": img_idx[i], "coords": coords[i], "draws": s["draws"],
                          "eps": s["eps"]})
    return frames, steps, count_gap


def compare(ev: dict, cfg: dict, traffic: dict, device, sides=("program",)) -> dict:
    """{side: readings against the reference} for each side: "program"
    (what the timed path produced), "control" (the reference at the
    precision below the configuration's, in the program's place) or
    "half_batch" (the reference in the program's place, each batch halved:
    a planted fault). The reference computes at the configuration's
    precision["reference"]."""
    frames, steps, count_gap = reference_inputs(ev, cfg, device)
    if count_gap:
        bad = {"site_count_gap": float(count_gap), "loss_gap_step1": math.inf,
               "terms_gap_step1": math.inf, "grad_diff_median": math.inf,
               "grad_diff_q70": math.inf, "change_gap": math.inf}
        return {side: bad for side in sides}
    b = spec.binding(cfg["model"])
    follow = lambda precision, half=False: drive.follow_training(
        b.reference_loss, b.PAIRED, ev["w0"], frames, steps, cfg, ev["lrs"], precision, half)
    stated = cfg["precision"]["reference"]
    ref = follow(stated)
    got = {"program": lambda: ev, "control": lambda: follow(cfg["precision"]["control"]),
           "half_batch": lambda: follow(stated, True)}
    out = {}
    for side in sides:
        g = got[side]()
        out[side] = {"site_count_gap": 0.0, **program_readings(g, ref)}
        print(json.dumps({"side": side, **detail(g, ref)}), file=sys.stderr)
    return out
