"""Host spans, and the device trace of a short window read into plain lists.

`Spans` times the benchmark's own calls into the program's layers on the
host clock. `capture` runs a function under torch.profiler and returns a
`Trace`: every device operation (kernel, copy, set) and every span the
function opened, in microseconds on the trace's clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

class Spans:
    """Named host spans: (name, start, end) in perf_counter seconds."""

    def __init__(self):
        self.done: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.done.append((name, t0, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.done if n == name)


@dataclass
class Trace:
    """Device operations and host spans of one traced window (microseconds)."""

    ops: list[tuple[str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    info: dict = field(default_factory=dict)

    @property
    def window(self) -> tuple[float, float]:
        return min(s[1] for s in self.spans), max(s[2] for s in self.spans)

    def ops_in(self, start: float, end: float) -> list[tuple[str, float, float]]:
        """Operations that start within [start, end)."""
        return [o for o in self.ops if start <= o[1] < end]

    def spans_named(self, name: str) -> list[tuple[str, float, float]]:
        return [s for s in self.spans if s[0] == name]


def busy_intervals(ops, start: float, end: float) -> list[tuple[float, float]]:
    """The union of the operations' intervals, clipped to [start, end]."""
    merged: list[list[float]] = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(trace: Trace) -> float:
    start, end = trace.window
    return sum(b - a for a, b in busy_intervals(trace.ops, start, end))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations with the most time, and the device's idle time
    by the innermost host span open while it lasted, in seconds."""
    start, end = trace.window
    by_op: dict[str, float] = defaultdict(float)
    for name, a, b in trace.ops:
        by_op[name[:200]] += (b - a) * 1e-6
    gaps: dict[str, float] = defaultdict(float)
    edges = sorted({e for s in trace.spans for e in s[1:]})
    t = start
    for a, b in busy_intervals(trace.ops, start, end) + [(end, end)]:
        if a > t:  # an idle gap [t, a), split where the host's spans open or close
            cuts = [t] + [e for e in edges if t < e < a] + [a]
            for u, v in zip(cuts, cuts[1:]):
                gaps[_open_span(trace.spans, u)] += (v - u) * 1e-6
        t = max(t, b)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


def _open_span(spans, t: float) -> str:
    open_ = [s for s in spans if s[1] <= t < s[2]]
    return min(open_, key=lambda s: s[2] - s[1])[0] if open_ else "between spans"


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def capture(fn, spans: Spans, device) -> Trace:
    """Run fn() under torch.profiler, tracing the device alone (recording
    every host operation as well would slow the host several-fold and starve
    the device). The spans that fn() opens are placed on the trace's clock by
    a marker kernel launched on an idle device just before fn() and another
    just after it."""
    from torch.profiler import ProfilerActivity, profile

    trace = Trace()
    if device.type != "cuda":  # no device to trace: the spans alone
        t0 = time.perf_counter()
        fn()
        trace.spans = [(n, a * 1e6, b * 1e6) for n, a, b in spans.done if a >= t0]
        return trace
    marks = []
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for phase in (0, 1):
            marks.append(time.perf_counter())
            torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            if phase == 0:
                fn()
                torch.cuda.synchronize(device)
    ops = sorted(((ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA), key=lambda o: o[1])
    found = [o for o in ops if MARKER in o[0]]
    first, last = found[0], found[-1]
    offset = first[1] - marks[0] * 1e6
    trace.info["clock_drift_us"] = (last[1] - marks[1] * 1e6) - offset
    trace.ops = [o for o in ops if o is not first and o is not last]
    trace.spans = [(n, a * 1e6 + offset, b * 1e6 + offset) for n, a, b in spans.done
                   if a >= marks[0]]
    return trace
