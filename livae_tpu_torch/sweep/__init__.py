"""Hyperparameter sweeps (port of livae_tpu/sweep without the stacked
trials, ROADMAP queue 1 item 14c): the native search engine."""

from .search import (
    ASHAScheduler,
    PBTScheduler,
    RandomSearcher,
    StopTrial,
    TPESearcher,
    Trial,
    choice,
    get_best_result,
    loguniform,
    run_search,
    sample_config,
    uniform,
)

__all__ = [
    "ASHAScheduler",
    "PBTScheduler",
    "RandomSearcher",
    "StopTrial",
    "TPESearcher",
    "Trial",
    "choice",
    "get_best_result",
    "loguniform",
    "run_search",
    "sample_config",
    "uniform",
]
