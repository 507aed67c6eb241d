"""Stacked trials: K sweep trials trained in one vmapped program (port of
livae_tpu/sweep/stacked.py).

K hyperparameter configs of one architecture train at once: the K lanes'
parameters are stacked leaf tensors [K, ...] (`torch.func.stack_module_state`),
and every step runs the K lanes' forward as one `torch.func.vmap` of
`functional_call` over a storage-free (meta) copy of the model. Under the vmap
the convolutions become grouped convolutions, and the rotation kernels' vmap
rules (`ops.rot3.Rot3Function`, `ops.shear.FractionalShiftFunction`) fold the
lanes into the batch: a rotation of K lanes of B canvases is one launch on
K x B canvases, so the launches per step do not grow with K.

What may differ per lane: lr and weight decay (`set_stacked_hyperparams`, [K]
tensors), beta and gamma (step arguments) and the init seed. What a stack
shares: `STRUCTURAL_KEYS`; `run_search_stacked` groups configs by them.

A lane is the same experiment as the sequential trial with its seed: its
randomness is drawn outside the vmap from its own generator in the order the
sequential fused step draws it (the batch's augmentation draws, then the
reparameterisation noise), its gradient is clipped by its own global norm,
and its AdamW update is the formula of `torch.optim.AdamW`. The gradients come
from plain autograd on the sum of the lanes' losses: `torch.func.grad` would
hand the kernels' backward a functorch-wrapped cotangent, which has no data
pointer for the kernel.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
from torch.func import functional_call, stack_module_state, vmap

from ..data.pipeline import PairedDraws, extract_batch, sample_paired_draws
from ..train.engine import (
    FUSED_VAE_METRIC_NAMES,
    _generic_eval_metrics,
    _generic_loss,
    _on_device,
)
from .search import Trial, _make_searcher, _write_results

__all__ = [
    "stack_trees",
    "unstack_tree",
    "make_stacked_fns",
    "set_stacked_hyperparams",
    "run_search_stacked",
    "STRUCTURAL_KEYS",
]

# Config keys that change shapes (or the epoch's program) and therefore must be
# the same within one stack.
STRUCTURAL_KEYS = (
    "patch_size", "padding", "latent_dim", "batch_size", "epochs",
    "val_split", "grad_max_norm", "normalize", "beta_annealing",
    "beta_annealing_epochs",
)

# torch.optim.AdamW's defaults as make_optimizer sets them (optax's)
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack identically-structured trees (dicts, lists or tuples of tensors,
    such as state dicts) along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees(list(xs)) for xs in zip(*trees))
    return torch.stack(list(trees))


def unstack_tree(tree: Any, k: int) -> list[Any]:
    """Inverse of stack_trees: split axis 0 into k trees."""
    if isinstance(tree, dict):
        lanes = [unstack_tree(v, k) for v in tree.values()]
        return [dict(zip(tree, vals)) for vals in zip(*lanes)]
    if isinstance(tree, (list, tuple)):
        lanes = [unstack_tree(v, k) for v in tree]
        return [type(tree)(vals) for vals in zip(*lanes)]
    return [tree[i] for i in range(k)]


@dataclass
class StackedState:
    """The training state of K lanes: stacked parameters (leaf tensors [K, ...]
    that take gradients), AdamW's moments, the step count the lanes share,
    and each lane's lr and weight decay ([K] float32, the injected
    hyperparameters of the JAX package's optimizer)."""

    params: dict[str, torch.Tensor]
    exp_avg: dict[str, torch.Tensor]
    exp_avg_sq: dict[str, torch.Tensor]
    learning_rate: torch.Tensor
    weight_decay: torch.Tensor
    step: int = 0

    @classmethod
    def create(cls, models: Sequence[torch.nn.Module], learning_rate: float = 1e-3,
               weight_decay: float = 1e-5) -> "StackedState":
        """Stack the weights of K models of one architecture (each lane starts
        from its model's weights, copied); the models are left as they are."""
        if any(True for _ in models[0].buffers()):
            raise ValueError("stacked trials take models without buffers")
        params, _ = stack_module_state(list(models))
        K = len(models)
        dev = next(iter(params.values())).device
        return cls(
            params=params,
            exp_avg={k: torch.zeros_like(v) for k, v in params.items()},
            exp_avg_sq={k: torch.zeros_like(v) for k, v in params.items()},
            learning_rate=torch.full((K,), learning_rate, dtype=torch.float32, device=dev),
            weight_decay=torch.full((K,), weight_decay, dtype=torch.float32, device=dev),
        )

    @property
    def lanes(self) -> int:
        return int(self.learning_rate.shape[0])

    def lane_state_dict(self, i: int) -> dict[str, torch.Tensor]:
        """Lane i's weights as a model's state dict."""
        return {k: v[i].detach().clone() for k, v in self.params.items()}


def set_stacked_hyperparams(state: StackedState, learning_rates, weight_decays) -> StackedState:
    """Per-lane lr and weight decay: [K] values, read by the next steps."""
    dev = state.learning_rate.device
    lr = torch.as_tensor(learning_rates, dtype=torch.float32, device=dev)
    wd = torch.as_tensor(weight_decays, dtype=torch.float32, device=dev)
    if lr.shape != (state.lanes,) or wd.shape != (state.lanes,):
        raise ValueError(f"expected {state.lanes} learning rates and weight decays, got "
                         f"{tuple(lr.shape)} and {tuple(wd.shape)}")
    state.learning_rate, state.weight_decay = lr, wd
    return state


def _lane_view(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [K] tensor shaped to broadcast over `like`'s [K, ...]."""
    return t.view(-1, *([1] * (like.dim() - 1)))


@torch.no_grad()
def _clip_lanes(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Each lane's gradients scaled in place by min(1, max_norm / max(gnorm, 1e-12))
    of that lane's global norm; returns min(gnorm, max_norm) per lane [K] (the
    formula of train.engine._clip_by_global_norm, lane by lane)."""
    gnorm = torch.sqrt(torch.stack([(g * g).flatten(1).sum(1) for g in grads]).sum(0))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(_lane_view(scale, g))
    return torch.clamp(gnorm, max=max_norm)


@torch.no_grad()
def _adamw_lanes(state: StackedState) -> None:
    """One AdamW step of every lane with its own lr and weight decay: the
    single-tensor formula of torch.optim.AdamW (decoupled decay, then the
    moments, then the bias-corrected update)."""
    b1, b2 = ADAM_BETAS
    state.step += 1
    bias1 = 1 - b1 ** state.step
    bias2_sqrt = math.sqrt(1 - b2 ** state.step)
    for name, p in state.params.items():
        g = p.grad
        if g is None:
            continue
        lr = _lane_view(state.learning_rate, p)
        p.mul_(1 - lr * _lane_view(state.weight_decay, p))
        m, v = state.exp_avg[name], state.exp_avg_sq[name]
        m.lerp_(g, 1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / bias2_sqrt).add_(ADAM_EPS)
        p.sub_(lr / bias1 * m / denom)


def _cat_draws(draws: Sequence[PairedDraws]) -> PairedDraws:
    return PairedDraws(*(torch.cat([getattr(d, f.name) for d in draws])
                         for f in dataclasses.fields(PairedDraws)))


def make_stacked_fns(model: torch.nn.Module, *, patch_size: int, padding: int, cfg,
                     margin: int, grad_max_norm: float = 5.0, normalize: bool = True,
                     use_diversity: bool = False, device=None):
    """The stacked whole-epoch train step and eval of `model`'s architecture:
    the K-lane counterparts of `make_fused_vae_train_step` and
    `make_fused_eval` (the sweep trial's), with the JAX package's argument
    order.

    stacked_step(state, frames_padded, img_idx, coords, idx_batches[K, S, B],
    generators, beta[K], gamma[K], draws=None, eps=None) -> (state, {name: [K]}),
    the step means of each lane, updating `state` (a StackedState) in place.
    stacked_eval(params, frames_padded, img_idx, coords, idx_batches[K, S, B],
    generators, beta[K], gamma[K], eps=None) -> {name: [K, S]}, without
    gradients; `params` is a StackedState's.

    `generators` holds one generator per lane (on the device); lane k's draws
    come from generators[k] in the sequential step's order. `draws[k][s]`
    (PairedDraws) and `eps[k][s]` ([B, latent]) replace them, to reproduce
    another implementation's randomness. Each step extracts the K lanes'
    batches in one call on K x B sites.
    """
    dev = _on_device(model, device)
    meta = copy.deepcopy(model).to("meta")  # the architecture; weights come per lane

    def lane_model(params):
        return lambda x, eps, generator=None: functional_call(meta, params, (x, eps))

    def lane_loss(params, x, eps, beta, gamma):
        total, aux = _generic_loss(lane_model(params), x, beta, gamma, use_diversity, eps)
        return total, aux["rl"], aux["kl"], aux["cyc"]

    def lane_eval(params, x, eps, beta, gamma):
        return _generic_eval_metrics(lane_model(params), x, beta, gamma, use_diversity, 0.0,
                                     eps, None)

    def batch(frames_padded, img_idx, coords, idx, generators, draws, eps, augment):
        """Lane k's augmentation draws (with `augment`) then its noise, for
        every lane, unless given; the lanes' batches extracted in one call:
        ([K, B, 1, P, P], [K, B, latent])."""
        K, B = idx.shape
        lane_draws, lane_eps = [], []
        for k in range(K):
            if augment:
                lane_draws.append(draws[k] if draws is not None
                                  else sample_paired_draws(B, cfg, generators[k], dev))
            lane_eps.append(eps[k] if eps is not None else torch.randn(
                (B, meta.latent_dim), generator=generators[k], device=dev))
        flat = idx.reshape(-1)
        x = extract_batch(frames_padded, img_idx[flat], coords[flat], patch_size, padding,
                          normalize=normalize, margin=margin, cfg=cfg if augment else None,
                          draws=_cat_draws(lane_draws) if augment else None)
        return x.unflatten(0, (K, B)), torch.stack(lane_eps)

    def lanes_tensor(values, K):
        return torch.as_tensor(values, dtype=torch.float32, device=dev).expand(K).contiguous()

    def stacked_step(state: StackedState, frames_padded, img_idx, coords, idx_batches,
                     generators, beta, gamma, draws=None, eps=None):
        K, S = idx_batches.shape[:2]
        beta, gamma = lanes_tensor(beta, K), lanes_tensor(gamma, K)
        acc = torch.zeros((K, len(FUSED_VAE_METRIC_NAMES)), device=dev)
        for s in range(S):
            with torch.no_grad():
                x, lane_eps = batch(frames_padded, img_idx, coords, idx_batches[:, s], generators,
                                    None if draws is None else [d[s] for d in draws],
                                    None if eps is None else [e[s] for e in eps],
                                    cfg is not None)
            for p in state.params.values():
                p.grad = None
            total, rl, kl, cyc = vmap(lane_loss)(state.params, x, lane_eps, beta, gamma)
            total.sum().backward()
            grads = [p.grad for p in state.params.values() if p.grad is not None]
            gnorm = _clip_lanes(grads, grad_max_norm)
            _adamw_lanes(state)
            with torch.no_grad():
                acc += torch.stack([total, rl, kl, cyc, gnorm], dim=1).detach()
        means = acc / S
        return state, {name: means[:, i] for i, name in enumerate(FUSED_VAE_METRIC_NAMES)}

    @torch.no_grad()
    def stacked_eval(params, frames_padded, img_idx, coords, idx_batches, generators, beta,
                     gamma, eps=None):
        K, S = idx_batches.shape[:2]
        beta, gamma = lanes_tensor(beta, K), lanes_tensor(gamma, K)
        per_batch = []
        for s in range(S):
            x, lane_eps = batch(frames_padded, img_idx, coords, idx_batches[:, s], generators,
                                None, None if eps is None else [e[s] for e in eps], False)
            per_batch.append(vmap(lane_eval)(params, x, lane_eps, beta, gamma))
        return {k: torch.stack([m[k] for m in per_batch], dim=1) for k in per_batch[0]}

    return stacked_step, stacked_eval


def _structural_signature(config: dict, keys: Sequence[str]) -> tuple:
    return tuple((k, config[k]) for k in keys if k in config)


def run_search_stacked(
    stacked_trainable: Callable[[list[dict], Callable], None],
    param_space: dict,
    num_samples: int = 8,
    stack_size: int = 4,
    metric: str = "loss",
    mode: str = "min",
    results_dir: str | Path = "sweep_results",
    seed: int = 0,
    search_alg: str | None = None,
    structural_keys: Sequence[str] = STRUCTURAL_KEYS,
) -> list[Trial]:
    """Run a sweep in stacks of up to `stack_size` trials.

    Rounds: suggest `stack_size` configs from the searcher (TPE sees every
    finished stack's observations), group them by structural signature, and
    hand each group to `stacked_trainable(configs, report)`, which calls
    ``report(lane, epoch, **metrics)`` per lane per epoch. Early-stopping
    schedulers do not apply inside a stack (its lanes share one program), so
    every trial runs its full epoch budget. A group that raises marks its
    trials "error" and the search goes on.

    Writes the same results.json as run_search; returns all trials.
    """
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    searcher = _make_searcher(search_alg, param_space, metric, mode, seed)

    trials: list[Trial] = []
    observations: list[tuple[dict, float]] = []
    while len(trials) < num_samples:
        k = min(stack_size, num_samples - len(trials))
        configs = [searcher.suggest(observations) for _ in range(k)]
        groups: dict[tuple, list[dict]] = {}
        for cfg in configs:
            groups.setdefault(_structural_signature(cfg, structural_keys), []).append(cfg)
        for group in groups.values():
            base_id = len(trials)
            group_trials = [Trial(trial_id=base_id + i, config=cfg, status="running")
                            for i, cfg in enumerate(group)]
            trials.extend(group_trials)

            def report(lane: int, epoch: int, checkpoint: Any = None, **metrics):
                t = group_trials[lane]
                t.history.append({"epoch": epoch, **metrics})
                if checkpoint is not None:
                    t.checkpoint = checkpoint

            try:
                stacked_trainable([dict(c) for c in group], report)
            except Exception as e:  # noqa: BLE001 - a failing stack fails its trials only
                for t in group_trials:
                    t.status = "error"
                    t.error = f"{type(e).__name__}: {e}"
                continue
            for t in group_trials:
                t.status = "done"
                val = t.best(metric, mode)
                if val is not None:
                    observations.append((dict(t.config), val))
                last = t.last(metric)
                print(f"Trial {t.trial_id}: {t.status} after {len(t.history)} epochs "
                      f"(stacked x{len(group)}), {metric}={last if last is not None else 'n/a'}")

    _write_results(trials, results_dir, metric, mode)
    return trials
