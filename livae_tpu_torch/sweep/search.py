"""Native hyperparameter-search engine with Ray Tune's semantics (a copy of
livae_tpu/sweep/search.py: numpy and the standard library only).

Ray is not installed, so this engine gives the reference sweep's semantics
and artifacts:

* search space: `loguniform(lo, hi)`, `uniform(lo, hi)`, `choice(seq)`.
* `ASHAScheduler(metric, mode, max_t, grace_period, reduction_factor)`:
  asynchronous successive halving on reported epochs.
* `PBTScheduler(perturbation_interval, hyperparam_mutations, quantile)`:
  bottom-quantile trials exploit a top-quantile trial's config and weights
  and explore by perturbing the mutated hyperparameters. With concurrent
  execution the population is live: laggards exploit peers still running.
* `TPESearcher`: a native tree-structured Parzen estimator (HyperOptSearch's
  counterpart): univariate Parzen mixtures over good and bad observations,
  candidates scored by l(x)/g(x). search_alg="tpe", or "hyperopt", which
  says whether the hyperopt package is importable and uses this either way.
* `run_search(trainable, param_space, num_samples, scheduler, ...,
  max_concurrent=N, executor="thread"|"process")`: runs the trials, writes
  `results.json`, returns the trials (`get_best_result` picks the best).

Executors (the counterpart of Ray's fractional-GPU packing):
  * sequential: max_concurrent=1 (default), one trial at a time.
  * thread: worker threads share the local GPU; trials interleave on the
    device while host work (dataset reuse, checkpoint I/O, metrics)
    overlaps. Scheduler and searcher state sit under one lock.
  * process: one spawned process per trial slot, with the slot's
    environment from `trial_env(slot) -> {env}` (on a host with several
    GPUs, `CUDA_VISIBLE_DEVICES` gives each slot its own card). Trials talk
    to the parent's scheduler over pipes (report -> continue / stop /
    exploit). Needs a picklable (module-level) trainable.

Trial protocol: `trainable(config, report)` calls
`report(epoch=..., **metrics, checkpoint=state_or_path)` once per epoch;
report() raises `StopTrial` when the scheduler stops the trial, and may
return a PBT exploit payload {"config": ..., "checkpoint": ...} that the
trainable should adopt.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

__all__ = [
    "loguniform",
    "uniform",
    "choice",
    "sample_config",
    "StopTrial",
    "ASHAScheduler",
    "PBTScheduler",
    "RandomSearcher",
    "TPESearcher",
    "Trial",
    "run_search",
    "get_best_result",
]


class StopTrial(Exception):
    """Raised inside report() when the scheduler early-stops a trial."""


@dataclass(frozen=True)
class loguniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclass(frozen=True)
class uniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator):
        return float(rng.uniform(self.low, self.high))


@dataclass(frozen=True)
class choice:
    values: tuple

    def __init__(self, values):
        object.__setattr__(self, "values", tuple(values))

    def sample(self, rng: np.random.Generator):
        v = self.values[int(rng.integers(len(self.values)))]
        return v.item() if hasattr(v, "item") else v


def sample_config(param_space: dict, rng: np.random.Generator) -> dict:
    """Draw one config: samplers sampled, literals passed through."""
    return {
        k: (v.sample(rng) if hasattr(v, "sample") else v)
        for k, v in param_space.items()
    }


@dataclass
class Trial:
    trial_id: int
    config: dict
    status: str = "pending"  # pending | running | stopped | done | error
    history: list = field(default_factory=list)  # list of metric dicts
    checkpoint: Any = None
    error: str | None = None

    def last(self, key: str, default=None):
        for m in reversed(self.history):
            if key in m:
                return m[key]
        return default

    def best(self, key: str, mode: str = "min"):
        vals = [m[key] for m in self.history if key in m]
        if not vals:
            return None
        return min(vals) if mode == "min" else max(vals)


class ASHAScheduler:
    """Asynchronous successive halving (reference Ray ASHA semantics).

    Rungs at grace_period * reduction_factor^k; at each rung a trial
    continues only if its metric is within the top 1/reduction_factor of
    completed results at that rung.
    """

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 3,
    ):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = max(1, grace_period)
        self.reduction_factor = reduction_factor
        self._rungs: dict[int, list[float]] = {}
        r = self.grace_period
        while r < max_t:
            self._rungs[r] = []
            r *= reduction_factor

    def on_report(self, trial: Trial, epoch: int, metrics: dict) -> bool:
        """Returns True to continue, False to stop the trial."""
        if self.metric not in metrics:
            return True
        value = metrics[self.metric]
        if self.mode == "max":
            value = -value
        if epoch in self._rungs:
            rung = self._rungs[epoch]
            rung.append(value)
            k = max(1, math.ceil(len(rung) / self.reduction_factor))
            cutoff = sorted(rung)[k - 1]
            if value > cutoff:
                return False
        return epoch < self.max_t

    def on_trial_end(self, trial: Trial, trials: list[Trial]):
        return None


class PBTScheduler:
    """Population-based training: exploit + explore at intervals.

    Matches the reference's PBT use (time_attr="epoch",
    hyperparam_mutations on lr/beta, reference train_rvae_raytune.py:
    353-363). At each perturbation interval, a bottom-quantile trial
    copies a top-quantile trial's config and checkpoint and perturbs each
    mutated hyperparameter by x0.8 / x1.2 (or resamples with p=0.25).
    Donors are drawn from the LIVE population: with concurrent executors
    a running peer's latest reported metric and checkpoint are used.
    """

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        perturbation_interval: int = 5,
        hyperparam_mutations: dict | None = None,
        quantile_fraction: float = 0.25,
        seed: int = 0,
    ):
        self.metric = metric
        self.mode = mode
        self.interval = max(1, perturbation_interval)
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.max_t = None  # set by run_search
        self._population: list[Trial] = []
        self._rng = np.random.default_rng(seed)

    def on_report(self, trial: Trial, epoch: int, metrics: dict):
        """Returns True to continue; or an exploit payload dict."""
        if self.metric not in metrics or epoch % self.interval != 0:
            return True
        peers = [
            t for t in self._population
            if t is not trial and t.last(self.metric) is not None
        ]
        if len(peers) < 2:
            return True
        sign = 1 if self.mode == "min" else -1
        scored = sorted(
            peers + [trial], key=lambda t: sign * t.last(self.metric, math.inf)
        )
        n = len(scored)
        k = max(1, int(n * self.quantile))
        bottom = scored[n - k :]
        if trial not in bottom:
            return True
        top = scored[:k]
        donor = top[int(self._rng.integers(len(top)))]
        new_config = dict(donor.config)
        for key, sampler in self.mutations.items():
            if key not in new_config:
                continue
            if self._rng.random() < 0.25 and hasattr(sampler, "sample"):
                new_config[key] = sampler.sample(self._rng)
            else:
                new_config[key] = new_config[key] * float(
                    self._rng.choice([0.8, 1.2])
                )
        return {"config": new_config, "checkpoint": donor.checkpoint}

    def on_trial_end(self, trial: Trial, trials: list[Trial]):
        return None


# ---------------------------------------------------------------------------
# Search algorithms (config suggesters)
# ---------------------------------------------------------------------------


class RandomSearcher:
    """IID sampling from the search space (Ray's BasicVariantGenerator)."""

    def __init__(self, param_space: dict, seed: int = 0):
        self.param_space = param_space
        self._rng = np.random.default_rng(seed)

    def suggest(self, observations: list[tuple[dict, float]]) -> dict:
        return sample_config(self.param_space, self._rng)


def _norm_logpdf_mix(u: float, centers: np.ndarray, bw: float) -> float:
    """log pdf of a Parzen mixture (Gaussians at `centers` + uniform prior)."""
    if len(centers) == 0:
        return 0.0  # uniform on [0, 1]
    z = (u - centers) / bw
    comp = np.exp(-0.5 * z * z) / (bw * math.sqrt(2 * math.pi))
    pdf = (np.sum(comp) + 1.0) / (len(centers) + 1)  # +1: uniform prior, pdf 1
    return float(np.log(max(pdf, 1e-300)))


class TPESearcher:
    """Native tree-structured Parzen estimator (HyperOptSearch equivalent).

    Univariate TPE (hyperopt's default factorization): observations are
    split into good (top `gamma` fraction by objective) and bad; for each
    numeric parameter a Parzen mixture is fit over each group in the
    parameter's natural space (log for loguniform) normalized to [0, 1],
    candidates are drawn from the good mixture and the one maximizing
    l(x)/g(x) wins. Categorical parameters use smoothed count ratios.
    The first `n_startup` suggestions are random.
    """

    def __init__(
        self,
        param_space: dict,
        metric: str = "loss",
        mode: str = "min",
        seed: int = 0,
        n_startup: int = 8,
        gamma: float = 0.25,
        n_candidates: int = 24,
    ):
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = np.random.default_rng(seed)

    def _split(self, observations: list[tuple[dict, float]]):
        vals = np.asarray([v for _, v in observations], dtype=float)
        if self.mode == "max":
            vals = -vals
        order = np.argsort(vals, kind="stable")
        # hyperopt's sqrt-sized elite set: only the genuinely best points
        # define l(x); a linear fraction dilutes them and stalls refinement.
        # Ties at the cutoff are all included — otherwise equally-optimal
        # points land in the bad set and poison categorical ratios.
        n_good = max(2, int(math.ceil(self.gamma * math.sqrt(len(vals)))))
        cutoff = vals[order[n_good - 1]]
        good_idx = {int(i) for i in order if vals[i] <= cutoff}
        good = [observations[i][0] for i in range(len(observations)) if i in good_idx]
        bad = [observations[i][0] for i in range(len(observations)) if i not in good_idx]
        return good, bad

    def _suggest_numeric(self, sampler, good_vals, bad_vals):
        log = isinstance(sampler, loguniform)
        lo, hi = float(sampler.low), float(sampler.high)
        a, b = (math.log(lo), math.log(hi)) if log else (lo, hi)

        def to_unit(xs):
            xs = np.asarray(xs, dtype=float)
            if log:
                xs = np.log(np.clip(xs, lo, hi))
            return (xs - a) / (b - a)

        g = to_unit(good_vals)
        bd = to_unit(bad_vals)

        def bw(xs):
            # hyperopt-style floor range/(n+2): wide early mixtures make the
            # density argmax bisect the elite points (directed refinement);
            # a collapsing bandwidth freezes the search on a mediocre cluster
            return float(np.clip(np.std(xs), 1.0 / (len(xs) + 2), 0.5))

        bw_g, bw_b = bw(g), bw(bd)

        best_u, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            if len(g) and self._rng.random() < 0.9:
                c = float(g[int(self._rng.integers(len(g)))])
                u = float(np.clip(self._rng.normal(c, bw_g), 0.0, 1.0))
            else:  # exploration draw from the prior
                u = float(self._rng.uniform())
            score = _norm_logpdf_mix(u, g, bw_g) - _norm_logpdf_mix(u, bd, bw_b)
            if score > best_score:
                best_u, best_score = u, score
        x = a + best_u * (b - a)
        return float(math.exp(x)) if log else float(x)

    def _suggest_choice(self, sampler, good_vals, bad_vals):
        values = list(sampler.values)
        cg = np.array([1.0 + sum(v == gv for gv in good_vals) for v in values])
        cb = np.array([1.0 + sum(v == bv for bv in bad_vals) for v in values])
        pg = cg / cg.sum()
        pb = cb / cb.sum()
        # sample candidates from the good distribution, score by ratio
        idx = self._rng.choice(len(values), size=self.n_candidates, p=pg)
        best = max(set(idx.tolist()), key=lambda i: pg[i] / pb[i])
        v = values[best]
        return v.item() if hasattr(v, "item") else v

    def suggest(self, observations: list[tuple[dict, float]]) -> dict:
        if len(observations) < self.n_startup:
            return sample_config(self.param_space, self._rng)
        good, bad = self._split(observations)
        out = {}
        for k, sampler in self.param_space.items():
            if not hasattr(sampler, "sample"):
                out[k] = sampler
                continue
            gv = [c[k] for c in good if k in c]
            bv = [c[k] for c in bad if k in c]
            if isinstance(sampler, choice):
                out[k] = self._suggest_choice(sampler, gv, bv)
            elif isinstance(sampler, (loguniform, uniform)) and gv:
                out[k] = self._suggest_numeric(sampler, gv, bv)
            else:
                out[k] = sampler.sample(self._rng)
        return out


def _make_searcher(search_alg, param_space, metric, mode, seed):
    if search_alg in ("hyperopt", "tpe"):
        if search_alg == "hyperopt":
            try:
                import hyperopt  # noqa: F401

                # hyperopt exists: the native TPE is used all the same (the
                # same algorithm family, no extra process model); say so.
                print("search_alg=hyperopt: using native TPE implementation")
            except ImportError:
                print("hyperopt not installed: using native TPE implementation")
        return TPESearcher(param_space, metric=metric, mode=mode, seed=seed)
    return RandomSearcher(param_space, seed=seed)


def _random_search_configs(param_space, num_samples, seed):
    rng = np.random.default_rng(seed)
    return [sample_config(param_space, rng) for _ in range(num_samples)]


# ---------------------------------------------------------------------------
# Execution backends
# ---------------------------------------------------------------------------


def _finalize_status(trial: Trial, scheduler) -> None:
    """StopTrial at the scheduler's max_t is completion, not a kill."""
    max_t = getattr(scheduler, "max_t", None)
    last_epoch = trial.history[-1]["epoch"] if trial.history else 0
    trial.status = "done" if (max_t and last_epoch >= max_t) else "stopped"


def _run_threaded(
    trainable,
    searcher,
    num_samples,
    scheduler,
    metric,
    mode,
    max_concurrent,
) -> list[Trial]:
    """Thread-pool executor (also the sequential path with 1 worker).

    All scheduler/searcher/trial mutations happen under one lock; the
    trainable itself runs unlocked, so device work from different trials
    overlaps. PBT sees the live population.
    """
    lock = threading.RLock()
    trials: list[Trial] = []
    observations: list[tuple[dict, float]] = []
    if isinstance(scheduler, PBTScheduler):
        scheduler._population = trials

    def next_trial() -> Trial | None:
        with lock:
            if len(trials) >= num_samples:
                return None
            config = searcher.suggest(list(observations))
            trial = Trial(trial_id=len(trials), config=config, status="running")
            trials.append(trial)
            return trial

    def run_one(trial: Trial) -> None:
        t0 = time.time()

        def report(epoch: int, checkpoint: Any = None, **metrics):
            with lock:
                entry = {"epoch": epoch, **metrics}
                trial.history.append(entry)
                if checkpoint is not None:
                    trial.checkpoint = checkpoint
                if scheduler is not None:
                    decision = scheduler.on_report(trial, epoch, metrics)
                    if decision is False:
                        raise StopTrial()
                    if isinstance(decision, dict):
                        trial.config.update(decision["config"])
                        return decision
            return None

        try:
            trainable(dict(trial.config), report)
            trial.status = "done"
        except StopTrial:
            _finalize_status(trial, scheduler)
        except Exception as e:  # trial failure tolerated, like Ray
            trial.status = "error"
            trial.error = f"{type(e).__name__}: {e}"
            print(f"Trial {trial.trial_id} failed: {trial.error}")
        with lock:
            if scheduler is not None:
                scheduler.on_trial_end(trial, trials)
            val = trial.best(metric, mode)
            if val is not None and trial.status in ("done", "stopped"):
                observations.append((dict(trial.config), val))
        dt = time.time() - t0
        last = trial.last(metric)
        print(
            f"Trial {trial.trial_id}: {trial.status} after "
            f"{len(trial.history)} epochs ({dt:.0f}s), {metric}="
            f"{last if last is not None else 'n/a'}"
        )

    def worker():
        while True:
            trial = next_trial()
            if trial is None:
                return
            run_one(trial)

    n_workers = max(1, min(max_concurrent, num_samples))
    if n_workers == 1:
        worker()
    else:
        threads = [
            threading.Thread(target=worker, name=f"sweep-worker-{i}")
            for i in range(n_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return trials


def _process_trial_entry(conn, trainable, config, env):
    """Child-process entry: apply env pinning, run the trial, talk over the pipe."""
    import os

    if env:
        os.environ.update({k: str(v) for k, v in env.items()})

    def report(epoch: int, checkpoint: Any = None, **metrics):
        conn.send(("report", epoch, metrics, checkpoint))
        kind, payload = conn.recv()
        if kind == "stop":
            raise StopTrial()
        if kind == "exploit":
            config.update(payload["config"])
            return payload
        return None

    try:
        trainable(config, report)
        conn.send(("done", None, None, None))
    except StopTrial:
        conn.send(("stop_trial", None, None, None))
    except Exception as e:  # noqa: BLE001
        conn.send(("error", f"{type(e).__name__}: {e}", None, None))
    finally:
        conn.close()


def _run_processes(
    trainable,
    searcher,
    num_samples,
    scheduler,
    metric,
    mode,
    max_concurrent,
    trial_env: Callable[[int], dict] | None,
) -> list[Trial]:
    """Process-per-trial executor with per-slot env pinning (spawn).

    The parent is the single scheduler authority: children report over
    pipes and block for the decision (continue / stop / exploit payload).
    `trial_env(slot)` supplies the env for each of the `max_concurrent`
    slots: on a host with several GPUs, one card per slot through
    CUDA_VISIBLE_DEVICES. Requires a picklable (module-level) trainable;
    PBT checkpoints must be paths/values that pickle.
    """
    import multiprocessing as mp
    from multiprocessing.connection import wait as conn_wait

    ctx = mp.get_context("spawn")
    trials: list[Trial] = []
    observations: list[tuple[dict, float]] = []
    if isinstance(scheduler, PBTScheduler):
        scheduler._population = trials

    live: dict[Any, tuple[Trial, Any, int, float]] = {}  # conn -> (trial, proc, slot, t0)
    free_slots = list(range(max(1, min(max_concurrent, num_samples))))

    def launch() -> bool:
        if not free_slots or len(trials) >= num_samples:
            return False
        slot = free_slots.pop(0)
        config = searcher.suggest(list(observations))
        trial = Trial(trial_id=len(trials), config=config, status="running")
        trials.append(trial)
        parent_conn, child_conn = ctx.Pipe()
        # Deterministic trial identity for the child (seed/ckpt naming):
        # pids are not reproducible across runs and can collide on reuse.
        # Assigned unconditionally — trial_env(slot) is per-SLOT, and a
        # slot-constant id would make same-slot trials clobber each other.
        env = dict(trial_env(slot)) if trial_env else {}
        env["LIVAE_TRIAL_ID"] = str(trial.trial_id)
        proc = ctx.Process(
            target=_process_trial_entry,
            args=(child_conn, trainable, dict(config), env),
            daemon=True,
        )
        proc.start()
        child_conn.close()
        live[parent_conn] = (trial, proc, slot, time.time())
        return True

    def finish(conn, status: str, error: str | None = None):
        trial, proc, slot, t0 = live.pop(conn)
        conn.close()
        proc.join(timeout=30)
        trial.status = status
        trial.error = error
        if scheduler is not None:
            scheduler.on_trial_end(trial, trials)
        val = trial.best(metric, mode)
        if val is not None and status in ("done", "stopped"):
            observations.append((dict(trial.config), val))
        free_slots.append(slot)
        last = trial.last(metric)
        print(
            f"Trial {trial.trial_id}: {trial.status} after "
            f"{len(trial.history)} epochs ({time.time() - t0:.0f}s), {metric}="
            f"{last if last is not None else 'n/a'}"
        )

    while launch():
        pass
    while live:
        for conn in conn_wait(list(live.keys())):
            trial = live[conn][0]
            try:
                kind, a, b, c = conn.recv()
            except EOFError:  # child died without a terminal message
                finish(conn, "error", "child process exited unexpectedly")
                continue
            if kind == "report":
                epoch, metrics, checkpoint = a, b, c
                trial.history.append({"epoch": epoch, **metrics})
                if checkpoint is not None:
                    trial.checkpoint = checkpoint
                decision = True
                if scheduler is not None:
                    decision = scheduler.on_report(trial, epoch, metrics)
                if decision is False:
                    conn.send(("stop", None))
                elif isinstance(decision, dict):
                    trial.config.update(decision["config"])
                    conn.send(("exploit", decision))
                else:
                    conn.send(("continue", None))
            elif kind == "done":
                finish(conn, "done")
            elif kind == "stop_trial":
                trial_obj = trial
                _finalize_status(trial_obj, scheduler)
                finish(conn, trial_obj.status)
            elif kind == "error":
                print(f"Trial {trial.trial_id} failed: {a}")
                finish(conn, "error", a)
        while launch():
            pass
    return trials


def run_search(
    trainable: Callable[[dict, Callable], None],
    param_space: dict,
    num_samples: int = 10,
    scheduler: ASHAScheduler | PBTScheduler | None = None,
    metric: str = "loss",
    mode: str = "min",
    results_dir: str | Path = "sweep_results",
    seed: int = 0,
    search_alg: str | None = None,
    max_concurrent: int = 1,
    executor: str | None = None,
    trial_env: Callable[[int], dict] | None = None,
) -> list[Trial]:
    """Execute the sweep; writes results.json; returns all trials.

    search_alg: None/"random" for IID sampling, "tpe" for the native TPE,
    "hyperopt" as a Ray-compatible alias for TPE.
    max_concurrent: trials in flight at once (1 = sequential).
    executor: None (auto: sequential when max_concurrent==1, else
    "thread"), "thread", or "process" (spawned workers with per-slot env
    pinning via trial_env; needs a module-level trainable).
    """
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)

    searcher = _make_searcher(search_alg, param_space, metric, mode, seed)
    if executor is None:
        executor = "sequential" if max_concurrent <= 1 else "thread"

    if executor == "process":
        trials = _run_processes(
            trainable, searcher, num_samples, scheduler, metric, mode,
            max_concurrent, trial_env,
        )
    elif executor in ("sequential", "thread"):
        trials = _run_threaded(
            trainable, searcher, num_samples, scheduler, metric, mode,
            1 if executor == "sequential" else max_concurrent,
        )
    else:
        raise ValueError(f"unknown executor {executor!r}")

    _write_results(trials, results_dir, metric, mode)
    return trials


def _write_results(trials: list[Trial], results_dir: Path, metric: str, mode: str):
    rows = []
    for t in trials:
        rows.append(
            {
                "trial_id": t.trial_id,
                "status": t.status,
                "config": {k: v for k, v in t.config.items() if _jsonable(v)},
                "epochs": len(t.history),
                "history": [
                    {k: v for k, v in m.items() if _jsonable(v)} for m in t.history
                ],
                metric: t.best(metric, mode),
                "val_loss": t.best("val_loss", "min"),
                "checkpoint": t.checkpoint if isinstance(t.checkpoint, str) else None,
                "error": t.error,
            }
        )
    (results_dir / "results.json").write_text(json.dumps(rows, indent=2))
    print(f"Results written to {results_dir / 'results.json'}")


def _jsonable(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None), list, tuple))


def get_best_result(trials: list[Trial], metric: str = "loss", mode: str = "min"):
    """Best completed trial by metric (None if no successful trials)."""
    scored = [
        (t.best(metric, mode), t)
        for t in trials
        if t.status in ("done", "stopped") and t.best(metric, mode) is not None
    ]
    if not scored:
        return None
    sign = 1 if mode == "min" else -1
    return min(scored, key=lambda x: sign * x[0])[1]
