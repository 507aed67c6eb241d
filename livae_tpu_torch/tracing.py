"""The program's own spans and counters.

`span(name)` marks a phase of the program (a train step, its extraction,
its backward, an analysis batch). While recording, each span keeps one
`Record` in a bounded ring: its name, its start and end on the
`time.perf_counter_ns()` clock, the name of the span that encloses it, and a
tag shared by every span of one unit of work. A span opened with
`new_tag=True` (a train step, an eval or analysis batch, a pass) starts a
unit; the spans inside it inherit its tag.

Recording is on while a torch profiler is active in this thread (so a
profiled window records the phases beside the device's kernels) and inside
`recording()`. Otherwise `span` returns one shared no-op context: no
allocation, no record_function, no CUDA event, no synchronisation; only the
state check. Under `recording(ranges=True)` each span also opens a
`torch.profiler.record_function` range of its name, so that a profiler that
records the host (the entry points' `--profile`) writes the spans into its
trace.

`count(name, n)` adds to one of the process's counters (the hand-written
kernels' launches, by kernel and by launch variant), read by `counters()`;
`reset()` clears the counters and the ring. Both are exact when several
threads count (the sweep's thread executor).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

__all__ = ["Record", "RING_LENGTH", "span", "recording", "is_recording", "records", "count",
           "counters", "reset"]

RING_LENGTH = 1 << 16  # records kept; the oldest go first


class Record(NamedTuple):
    name: str
    start: int  # perf_counter_ns
    end: int
    parent: str | None  # the enclosing span's name
    tag: int


_ring: deque[Record] = deque(maxlen=RING_LENGTH)
_tags = itertools.count(1)
_open = threading.local()  # this thread's stack of open spans
_lock = threading.Lock()
_counts: dict[str, int] = {}
_forced = 0  # open recording() contexts
_ranges = 0  # open recording(ranges=True) contexts
_profiling = torch.autograd._profiler_enabled


class _Off:
    """The shared context of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "new_tag", "start", "parent", "tag", "range")

    def __init__(self, name: str, new_tag: bool):
        self.name, self.new_tag, self.range = name, new_tag, None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        self.tag = outer.tag if outer is not None and not self.new_tag else next(_tags)
        stack.append(self)
        if _ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.stack.pop()
        _ring.append(Record(self.name, self.start, end, self.parent, self.tag))
        return None


def span(name: str, new_tag: bool = False):
    """A context that records the phase `name` while recording is on."""
    if not (_forced or _profiling()):
        return _OFF
    return _Span(name, new_tag)


def is_recording() -> bool:
    return bool(_forced or _profiling())


@contextlib.contextmanager
def recording(ranges: bool = False):
    """Record spans inside the block, profiler or not; with `ranges`, also as
    record_function ranges."""
    global _forced, _ranges
    with _lock:
        _forced += 1
        _ranges += int(ranges)
    try:
        yield
    finally:
        with _lock:
            _forced -= 1
            _ranges -= int(ranges)


def records() -> list[Record]:
    """The ring's records, oldest first (each is appended when its span closes)."""
    return list(_ring)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Clear the counters and the ring."""
    with _lock:
        _counts.clear()
        _ring.clear()
