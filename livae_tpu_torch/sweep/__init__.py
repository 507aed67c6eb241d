"""Hyperparameter sweeps (port of livae_tpu/sweep): the native search engine
and the stacked trials (K trials of one architecture in one vmapped program)."""

from .stacked import (
    make_stacked_fns,
    run_search_stacked,
    set_stacked_hyperparams,
    stack_trees,
    unstack_tree,
)
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
    "make_stacked_fns",
    "run_search",
    "run_search_stacked",
    "sample_config",
    "set_stacked_hyperparams",
    "stack_trees",
    "uniform",
    "unstack_tree",
]
