"""The analysis pass users run after training, back to back in a closed loop:
`scripts/visualizations.collect_stats` over every site of the frames, un-augmented,
at the traffic's padding and batch size, each pass ending in its host copy.

The model is built as the analysis scripts build it (`RVAE(latent, patch)`:
float32 tensors, the fast rotation), with the benchmark's weights in place
of a checkpoint. The precision is PyTorch's default, which the scripts leave
alone: the convolutions in TF32, the dense layers in float32; the run checks
that the flags say what the configuration states.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import trace as T
from ..frames import stream_seed
from ..reference import common as RC, drive, sites as ref_sites
from .common import build_frames, init_device, make_weights, prebuild, sync


def _check_precision(stated: dict) -> None:
    """The flags must say what the configuration states: the run never sets them."""
    got = {"conv": "tf32" if torch.backends.cudnn.allow_tf32 else "float32",
           "matmul": "tf32" if torch.backends.cuda.matmul.allow_tf32 else "float32"}
    want = {k: stated[k] for k in got}
    if got != want:
        raise RuntimeError(f"the analysis computes {got}; the configuration states {want}")


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans: T.Spans):
        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        self.B = traffic["batch_size"]

    def setup(self) -> None:
        with self.spans("program_import"):
            from livae_tpu_torch.data.datasets import AdaptiveLatticeDataset
            from livae_tpu_torch.models.rvae import RVAE
            from livae_tpu_torch.scripts import visualizations

        cfg, dev = self.cfg, self.device
        _check_precision(cfg["precision"]["analyze"])
        with self.spans("cuda_init"):
            init_device(dev)
        with self.spans("kernels"):
            prebuild(dev)
        with self.spans("frames"):
            self.frames = build_frames(self.seed, self.traffic, dev)
        with self.spans("dataset_build"):
            self.ds = AdaptiveLatticeDataset(
                self.frames, patch_size=cfg["patch_size"], padding=self.traffic["padding"],
                transform=None, normalize=cfg["normalize"], device=dev)
        with self.spans("model"):
            model = RVAE(latent_dim=cfg["latent_dim"], patch_size=cfg["patch_size"], device=dev,
                         generator=torch.Generator().manual_seed(0))
            self.w0 = make_weights(model, self.seed, cfg["init"], dev)
            model.load_state_dict(self.w0)
            self.model = model.eval()
        self.collect = visualizations.collect_stats
        self.n_sites = len(self.ds)
        self.batches = [self.B] * (self.n_sites // self.B) + (
            [self.n_sites % self.B] if self.n_sites % self.B else [])
        with self.spans("first_calls"):
            self.passes = [self._pass()]

    def _pass(self):
        mu, logvar, err, _ = self.collect(self.model, self.ds, self.B, True)
        return mu, logvar, err

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        self.passes = []
        while not self.passes or time.perf_counter() - t0 < seconds:
            self.passes.append(self._pass())
        wall = time.perf_counter() - t0
        n = len(self.passes) * self.n_sites
        failed = sum(int((~np.isfinite(np.concatenate([m, lv, e[:, None]], 1))).any(1).sum())
                     for m, lv, e in self.passes)
        self.window_info = {"passes": len(self.passes), "seconds": wall, "sites": self.n_sites,
                            "batches": self.batches}
        print(f"window: {len(self.passes)} passes over {self.n_sites} sites in {wall:.3f} s "
              f"(batches {self.batches[0]} x {len(self.batches)})", flush=True)
        return {"attempted": n, "failed": failed,
                "metrics": {"encode_patches_per_s": n / wall}}

    def traced(self) -> T.Trace:
        def segment():
            for _ in range(self.traffic["trace_passes"]):
                with self.spans("pass"):
                    self._pass()

        tr = T.capture(segment, self.spans, self.device)
        tr.info |= {"passes": self.traffic["trace_passes"], "batches": self.batches}
        return tr

    def close(self) -> dict:
        pick = stream_seed(self.seed, "pass") % len(self.passes)
        mu, logvar, err = self.passes[pick]
        ev = {"frames": self.frames, "n_sites": self.n_sites, "w0": self.w0, "mu": mu,
              "logvar": logvar, "rec_err": err, "pass": pick}
        del self.model, self.ds, self.passes
        torch.cuda.empty_cache()
        return ev


def _site_gaps(got: np.ndarray, want: np.ndarray, scale: float) -> np.ndarray:
    """Per site, the largest gap over its entries, over `scale`."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return (d.max(1) if d.ndim == 2 else d) / scale


def altered(ev: dict) -> dict:
    """A planted fault: the program's answers with one site in a hundred
    given its neighbour's mu."""
    mu = ev["mu"].copy()
    i = np.arange(0, len(mu) - 1, 100)
    mu[i] = ev["mu"][i + 1]
    return {**ev, "mu": mu}


def compare(ev: dict, cfg: dict, traffic: dict, device, sides=("program",)) -> dict:
    """{side: readings against the float32 reference} for each side:
    "program" (the sampled pass of the window), "control" (the reference
    with its convolutions at the precision below the configuration's, in the
    program's place) or "altered" (the program's pass with a planted fault,
    `altered`); see `readings`."""
    padding, batch, latent = traffic["padding"], traffic["batch_size"], cfg["latent_dim"]
    frames, img_idx, coords, _ = ref_sites.build(ev["frames"], cfg["patch_size"], padding)
    if len(coords) != ev["n_sites"]:
        bad = {"site_count_gap": float(abs(len(coords) - ev["n_sites"])),
               **{k: math.inf for k in READINGS}}
        return {side: bad for side in sides}
    args = (ev["w0"], torch.as_tensor(frames, device=device), torch.as_tensor(img_idx, device=device),
            torch.as_tensor(coords, device=device), cfg, padding, batch)
    encode = lambda precision: {k: v.cpu().numpy() for k, v in
                                drive.encode_all(*args, precision, latent).items()}
    ref = encode({"conv": "float32", "io": "float32"})
    got = {"program": lambda: ev, "control": lambda: encode(cfg["precision"]["analyze"]["control"]),
           "altered": lambda: altered(ev)}
    conv = cfg["precision"]["analyze"]["conv"]
    return {side: readings(got[side](), ref, ev["w0"], side, conv) for side in sides}


READINGS = ("err_gap_q99", "err_gap_max", "mu_gap_q99", "mu_gap_max", "logvar_gap_q99",
            "logvar_gap_max", "mu_gap_cond_q99", "mu_gap_cond_max", "logvar_gap_cond_q99",
            "logvar_gap_cond_max")

# The unit roundoff of the precision the analysis states for its
# convolutions: how far rounding one operand can move it.
UNIT_ROUNDOFF = {"tf32": 2.0 ** -11}


def _latent_gaps(got: dict, ref: dict, w0: dict | None) -> dict:
    """mu's and logvar's largest gap per site over the size of the
    reference's output (the root mean square, over sites and dimensions, of
    the output less its bias)."""
    gaps = {}
    for name in ("mu", "logvar"):
        r = ref[name].astype(np.float64)
        d = np.abs(got[name].astype(np.float64) - r).max(1)
        bias = 0.0 if w0 is None else w0[f"encoder.fc_{name}.bias"].double().cpu().numpy()
        gaps[name] = d / np.sqrt(np.mean((r - bias) ** 2))
    return gaps


def readings(got: dict, ref: dict, w0: dict | None = None, side: str = "program",
             conv: str = "tf32") -> dict:
    """rec_err's gap per site over the reference's value, at the 99th
    percentile over sites and at the largest; mu's and logvar's
    (`_latent_gaps`) the same, and the same again over what rounding at the
    stated precision `conv` can cause at each site: the gap over the angle's
    condition number (`reference.rvae.angle_condition`) times the unit
    roundoff. Rounding turns an ill-conditioned site's angle, and with it its
    canonical patch and latents, by far more than a well-conditioned one's."""
    err = np.abs(got["rec_err"].astype(np.float64) - ref["rec_err"]) / ref["rec_err"]
    gaps = _latent_gaps(got, ref, w0)
    cond = ref["cond"].astype(np.float64)
    out = {"site_count_gap": 0.0, "err_gap_q99": float(np.quantile(err, 0.99)),
           "err_gap_max": float(err.max())}
    for name, g in gaps.items():
        scaled = g / (cond * UNIT_ROUNDOFF[conv])
        out[f"{name}_gap_q99"] = float(np.quantile(g, 0.99))
        out[f"{name}_gap_max"] = float(g.max())
        out[f"{name}_gap_cond_q99"] = float(np.quantile(scaled, 0.99))
        out[f"{name}_gap_cond_max"] = float(scaled.max())
    mu = gaps["mu"] / cond
    branch = RC.quarter_branch_distance(torch.as_tensor(ref["theta"])).numpy()
    print(f"angle's condition number ({side}): quantiles 0.1, 0.5, 0.9, 0.99 "
          f"{np.quantile(cond, [0.1, 0.5, 0.9, 0.99]).round(1).tolist()}", file=sys.stderr)
    for i in np.argsort(-mu)[:3]:
        print(f"site {i} ({side}): mu gap {gaps['mu'][i]:.6g}, logvar gap {gaps['logvar'][i]:.6g}, "
              f"rec_err gap {err[i]:.6g}, angle's condition {cond[i]:.4g}, reference theta "
              f"{float(ref['theta'][i, 0]):.6f} lies {branch[i]:.3e} rad from an odd multiple "
              f"of pi/4", file=sys.stderr)
    return out
