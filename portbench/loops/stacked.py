"""Stacked sweep trials, back to back in a closed loop: K lanes of one model
trained as one vmapped program, `sweep.stacked.make_stacked_fns`, as the
sweep's `--stacked K` trainable builds it (`run_search_stacked`): the lanes
share an architecture, a batch size and the sites, and differ in their
weights, learning rate, weight decay and beta. Each lane trains on unpaired
batches under the generic loss (the mean-reduced VAE loss on the model's
reconstruction), its gradient clipped by its own norm, AdamW per lane.

Each epoch gives every lane its own shuffle of the train split into steps of
`batch_size` sites; each step is one call of the stacked step on the K
lanes' batches, with a CUDA event before and after it, every lane's draws
and noise drawn by the benchmark on the device from the seed (the binding's
`draws`). After the steps the epoch's metrics are read on the host at once;
then the stacked eval runs every lane over the validation split, the full
batches and the ragged tail, as the sweep's trainable reads it. The lanes'
rates are constant over the window (the sweep's per-epoch cosine starts at
them).

Set-up builds the stack and drives its first three steps; the window goes on
from the fourth. The reference follows each lane's three steps from its
weights, sites, draws and noise at its rate and beta, with the model's
reference forward (`reference/<model>.py`'s `forward`) under the VAE
reference's loss; the worst lane's readings are the cell's.
"""

from __future__ import annotations

import importlib
import json
import math
import sys
import time

import numpy as np
import torch

from .. import spec, trace as T
from ..frames import stream_seed
from ..reference import drive, sites as ref_sites
from .common import (StepTimer, build_frames, generator, init_device, make_weights, percentile,
                     prebuild, split, sync)
from .train import CHECKED_STEPS, detail, program_readings


class Run:
    """One stacked cell's program side: set-up, window, traced segment and
    the evidence for the reference."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans: T.Spans):
        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        self.binding = spec.binding(cfg["model"])
        self.B, self.K = traffic["batch_size"], traffic["lanes"]

    # --- set-up ---

    def setup(self) -> None:
        with self.spans("program_import"):
            from livae_tpu_torch.data.datasets import AdaptiveLatticeDataset
            from livae_tpu_torch.data.pipeline import AugmentConfig
            from livae_tpu_torch.sweep.stacked import (StackedState, make_stacked_fns,
                                                       set_stacked_hyperparams)
            from livae_tpu_torch.train import engine

        cfg, dev, tr = self.cfg, self.device, self.traffic
        with self.spans("cuda_init"):
            init_device(dev)
        with self.spans("kernels"):
            prebuild(dev)
        with self.spans("frames"):
            self.frames = build_frames(self.seed, tr, dev)
        augment = AugmentConfig(**cfg["augment"])
        with self.spans("dataset_build"):
            ds = AdaptiveLatticeDataset(self.frames, patch_size=cfg["patch_size"],
                                        padding=cfg["padding"], transform=augment,
                                        normalize=cfg["normalize"], device=dev)
        self.n_sites = len(ds)
        self.train_idx, self.val_idx = split(self.n_sites, tr["val_split"], self.seed)
        self.site_table = ds.device_site_table[:3]
        self.train_dev = torch.as_tensor(self.train_idx, device=dev)
        self.steps_per_epoch = len(self.train_idx) // self.B
        if self.steps_per_epoch <= CHECKED_STEPS:
            raise ValueError(f"{len(self.train_idx)} train sites give {self.steps_per_epoch} "
                             f"steps of {self.B}; the cell needs more than {CHECKED_STEPS}")

        with self.spans("model"):
            models, self.w0 = [], []
            for k in range(self.K):
                m = self.binding.train_model(cfg, dev)
                w = make_weights(m, stream_seed(self.seed, "lane", k), cfg["init"], dev)
                m.load_state_dict(w)
                models.append(m)
                self.w0.append(w)
            loss = cfg["loss"]
            self.step, self.eval_fn = make_stacked_fns(
                models[0], patch_size=cfg["patch_size"], padding=cfg["padding"], cfg=augment,
                margin=ds._margin, grad_max_norm=cfg["grad_max_norm"],
                normalize=cfg["normalize"], use_diversity=loss["use_diversity"], device=dev)
            self.state = set_stacked_hyperparams(StackedState.create(models), tr["lr"],
                                                 [tr["weight_decay"]] * self.K)
            del models
        self.betas, self.gammas = list(tr["beta"]), [tr["gamma"]] * self.K
        self.engine = engine
        self.epoch = -1
        self._next_epoch()
        with self.spans("first_calls"):
            self.checked = self._checked_steps()
            self._eval("warm-up")

    def _next_epoch(self) -> None:
        self.epoch += 1
        self.gens = [generator(self.seed, "epoch", self.epoch, "lane", k, device=self.device)
                     for k in range(self.K)]
        S = self.steps_per_epoch
        self.idx = torch.stack([
            self.train_dev[torch.randperm(len(self.train_idx), generator=g,
                                          device=self.device)[:S * self.B]].reshape(S, self.B)
            for g in self.gens])  # [K, S, B]
        self.pos = 0

    def _call(self):
        """The next stacked step: (metrics {name: [K]}, each lane's draws and noise, indices [K, B])."""
        lanes = [self.binding.draws(self.cfg, self.B, g, self.device) for g in self.gens]
        idx = self.idx[:, self.pos:self.pos + 1]
        _, m = self.step(self.state, *self.site_table, idx, self.gens, self.betas, self.gammas,
                         draws=[[d] for d, _ in lanes], eps=[[e] for _, e in lanes])
        self.pos += 1
        return m, lanes, idx[:, 0]

    def _checked_steps(self) -> list[dict]:
        """Each lane's first three steps: losses, the first gradient as AdamW
        holds it after one step, every leaf's change after three."""
        st, K, beta1 = self.state, self.K, self.cfg["optimizer"]["betas"][0]
        lanes = [{"steps": [], "losses": []} for _ in range(K)]
        for t in range(CHECKED_STEPS):
            m, draws, idx = self._call()
            for k, lane in enumerate(lanes):
                lane["losses"].append(float(m["loss"][k]))
                d, e = draws[k]
                lane["steps"].append({"idx": idx[k].clone(), "eps": e.clone(),
                                      "draws": {n: v.clone() for n, v in vars(d).items()}})
                if t == 0:  # AdamW's first moment is (1 - beta1) times the clipped gradient
                    lane["terms"] = {n: float(v[k]) for n, v in m.items()}
                    lane["grads"] = {n: v[k] / (1 - beta1) for n, v in st.exp_avg.items()}
                    lane["grad_norms"] = {n: g.norm().item() for n, g in lane["grads"].items()}
        for k, lane in enumerate(lanes):
            lane["change_norms"] = {n: (p[k].detach() - self.w0[k][n]).norm().item()
                                    for n, p in st.params.items()}
        return lanes

    def _eval(self, tag) -> None:
        """Every lane over the validation split: the full batches, then the
        ragged tail as one smaller batch; read on the host."""
        gens = [generator(self.seed, "val", tag, "lane", k, device=self.device)
                for k in range(self.K)]
        val = torch.as_tensor(self.val_idx, dtype=torch.long, device=self.device)
        n = len(val)
        bs = min(self.B, n)
        parts = [val[:n // bs * bs].reshape(-1, bs)] + ([val[n // bs * bs:][None]] if n % bs else [])
        for part in parts:
            m = self.eval_fn(self.state.params, *self.site_table, part.expand(self.K, *part.shape),
                             gens, self.betas, self.gammas)
            self.engine.metrics_to_host(m)

    def _read(self, metrics: list[dict]) -> bool:
        names = list(metrics[0])
        stacked = {k: torch.stack([m[k] for m in metrics]) for k in names}
        host = self.engine.metrics_to_host(stacked)
        return all(np.isfinite(v).all() for v in host.values())

    # --- window ---

    def window(self, seconds: float) -> dict:
        dev, n = self.device, self.K * self.B
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
                self._eval(self.epoch)
                self._next_epoch()
        sync(dev)
        wall = time.perf_counter() - t0
        step_ms = timer.ms()
        self.window_info = {"steps": len(step_ms), "seconds": wall, "batch": n,
                            "epochs": self.epoch + 1}
        print(f"window: {len(step_ms)} stacked steps of {self.K} x {self.B} in {wall:.3f} s over "
              f"{self.epoch + 1} epochs ({self.n_sites} sites, {len(self.train_idx)} train, "
              f"{self.steps_per_epoch} steps an epoch); step ms median "
              f"{percentile(step_ms, 50):.3f}, p95 of {len(step_ms)} samples "
              f"{percentile(step_ms, 95):.3f}", flush=True)
        return {"attempted": len(step_ms), "failed": failed, "metrics": {
            "train_patches_per_s": len(step_ms) * n / wall,
            "train_step_ms_p95": percentile(step_ms, 95)}}

    def traced(self) -> T.Trace:
        """A short window under the profiler: stacked steps of a fresh epoch,
        the drain before the host read, the host read and the eval."""
        self._next_epoch()
        steps = min(self.traffic["trace_steps"], self.steps_per_epoch)
        out = []

        def segment():
            for _ in range(steps):
                with self.spans("step"):
                    out.append(self._call()[0])
            with self.spans("drain"):
                sync(self.device)
            with self.spans("host_read"):
                self._read(out)
            with self.spans("eval"):
                self._eval("traced")

        tr = T.capture(segment, self.spans, self.device)
        tr.info |= {"steps": steps, "batch": self.K * self.B, "lanes": self.K}
        return tr

    def close(self) -> dict:
        """Free the program's state; return the evidence for the reference."""
        ev = {"frames": self.frames, "n_sites": self.n_sites, "lanes": self.checked,
              "w0": [{k: v.detach().clone() for k, v in w.items()} for w in self.w0],
              "lr": list(self.traffic["lr"]), "beta": list(self.betas),
              "gamma": list(self.gammas), "weight_decay": self.traffic["weight_decay"]}
        del self.state, self.step, self.eval_fn, self.site_table
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return ev


def unpaired_loss(forward):
    """The VAE reference's loss (`reference/vae.py`: mean-reduced MSE plus
    beta times the mean KL) on the reconstruction of `forward(p, x, eps,
    precision)`, a model reference's forward whose outputs start (recon, _, _,
    mu, logvar): the generic loss the stacked step trains, for a model whose
    forward reconstructs in the input's frame."""

    def loss(p, x, eps, precision, loss_cfg: dict):
        recon, _, _, mu, logvar = forward(p, x, eps, precision)[:5]
        rl = torch.mean((recon - x) ** 2)
        kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
        return rl + loss_cfg["beta"] * kl, {"recon_loss": rl, "kld_loss": kl}

    return loss


def compare(ev: dict, cfg: dict, traffic: dict, device, sides=("program",)) -> dict:
    """{side: the worst lane's readings against the reference} for each side:
    "program", "control" (the reference at the precision below the
    configuration's, in the program's place) or "half_batch" (the reference
    in the program's place, each batch halved: a planted fault)."""
    frames, img_idx, coords, _ = ref_sites.build(ev["frames"], cfg["patch_size"], cfg["padding"])
    if len(coords) != ev["n_sites"]:
        bad = {"site_count_gap": float(abs(len(coords) - ev["n_sites"])),
               "loss_gap_step1": math.inf, "terms_gap_step1": math.inf,
               "grad_diff_median": math.inf, "grad_diff_q70": math.inf, "change_gap": math.inf}
        return {side: bad for side in sides}
    frames, img_idx, coords = (torch.as_tensor(a, device=device) for a in (frames, img_idx, coords))
    # the model's reference module, reference/<model>.py
    ref_model = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.reference.{cfg['model']}")
    loss = unpaired_loss(ref_model.forward)
    stated = cfg["precision"]["reference"]
    per_side: dict[str, list[dict]] = {side: [] for side in sides}
    for k, lane in enumerate(ev["lanes"]):
        steps = []
        for s in lane["steps"]:
            i = s["idx"].to(device)
            steps.append({"img_idx": img_idx[i], "coords": coords[i], "draws": s["draws"],
                          "eps": s["eps"]})
        lane_cfg = {**cfg, "optimizer": {**cfg["optimizer"], "weight_decay": ev["weight_decay"]},
                    "loss": {**cfg["loss"], "beta": ev["beta"][k], "gamma": ev["gamma"][k]}}
        lrs = [ev["lr"][k]] * CHECKED_STEPS
        follow = lambda precision, half=False: drive.follow_training(  # noqa: E731
            loss, False, ev["w0"][k], frames, steps, lane_cfg, lrs, precision, half)
        ref = follow(stated)
        got = {"program": lambda: lane, "control": lambda: follow(cfg["precision"]["control"]),
               "half_batch": lambda: follow(stated, True)}
        for side in sides:
            g = got[side]()
            per_side[side].append({"site_count_gap": 0.0, **program_readings(g, ref)})
            print(json.dumps({"side": side, "lane": k, **detail(g, ref)}), file=sys.stderr)
    return {side: {name: max(r[name] for r in rows) for name in rows[0]}
            for side, rows in per_side.items()}
