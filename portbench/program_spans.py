"""The program's own spans (`livae_tpu_torch.tracing`) on the traced window's
clock, and the device's idle time given to the program phase that left it.

The program records its spans while a torch profiler is active, so the
traced window (`trace.capture`) leaves them in the program's ring, on the
perf_counter clock of the benchmark's own spans. `capture` placed those on
the trace's clock; the same offset places the program's. Each idle interval
of the device goes to the innermost program span open over it, split where
spans open or close, as `trace.breakdown` does with the benchmark's spans.
A program without the tracer, or a trace that saw no device, gives None.

    python3 -m portbench.program_spans --workload <cell> --seed <n> --seconds <s> [--recording]

runs a cell's set-up, its measured window (with --recording: four windows,
recording off, on, on, off, each window's rate printed), the traced window,
and prints one JSON line: every program span's device idle and host self
time per step, batch or pass, the seven readers' values, the benchmark's idle
by its own spans, the share of it the program's spans name, the clock drift,
and the cost of a span with recording off and on. No reference runs.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

from .trace import busy_intervals

# the phases each per-layer metric reads (a phase's children listed with it)
EXTRACTION = ("draws", "indices", "extract", "crop", "resample", "rotate", "normalize")
MODEL = ("forward", "backward")
OPTIM = ("loss", "clip", "optimizer")
TRAIN_ENGINE = ("train.step", "metrics")
ENCODE_ENGINE = ("encode.pass", "encode.batch", "host_copy")


class Placed(NamedTuple):
    name: str
    start: float  # microseconds on the trace's clock
    end: float
    parent: str | None
    tag: int


def offset_us(ctx) -> float | None:
    """The offset `capture` put on the benchmark's spans: the traced window's
    spans are the last of `ctx.spans.done`, in order."""
    traced, done = ctx.trace.spans, ctx.spans.done
    if not traced or len(done) < len(traced):
        return None
    pairs = list(zip(traced, done[len(done) - len(traced):]))
    if any(t[0] != d[0] or abs((t[2] - t[1]) - (d[2] - d[1]) * 1e6) > 1.0 for t, d in pairs):
        return None
    return pairs[0][0][1] - pairs[0][1][1] * 1e6


def placed(ctx) -> list[Placed] | None:
    """The program's records inside the traced window, on the trace's clock;
    None without a device, without the tracer, or without the offset."""
    if not ctx.trace.ops:
        return None
    try:
        from livae_tpu_torch import tracing
    except ImportError:
        return None
    off = offset_us(ctx)
    if off is None:
        return None
    start, end = ctx.trace.window
    out = [Placed(r.name, r.start * 1e-3 + off, r.end * 1e-3 + off, r.parent, r.tag)
           for r in tracing.records()]
    return [r for r in out if start <= r.start and r.end <= end]


def idle_us(trace, recs: list[Placed]) -> list[float]:
    """Per record, the device's idle time (us) while it was the innermost
    record open, inside the traced window."""
    start, end = trace.window
    edges = sorted({start, end} | {e for r in recs for e in (r.start, r.end) if start < e < end})
    owner = []
    for u, v in zip(edges, edges[1:]):
        open_ = [i for i, r in enumerate(recs) if r.start <= u and v <= r.end]
        owner.append(min(open_, key=lambda i: recs[i].end - recs[i].start) if open_ else None)
    idle = [0.0] * len(recs)

    def gap(t: float, a: float) -> None:
        i = max(bisect.bisect_right(edges, t) - 1, 0)
        while i < len(owner) and edges[i] < a:
            if owner[i] is not None:
                idle[owner[i]] += min(edges[i + 1], a) - max(edges[i], t)
            i += 1

    t = start
    for a, b in busy_intervals(trace.ops, start, end) + [(end, end)]:
        if a > t:
            gap(t, a)
        t = max(t, b)
    return idle


def idle_ms(ctx, phases: tuple[str, ...], per: str, within: str | None = None) -> float | None:
    """The device's idle time (ms) under the program's spans named in
    `phases`, over the number of `per` spans; with `within`, only in the
    units (tags) of the spans so named."""
    recs = placed(ctx)
    if recs is None:
        return None
    n = sum(r.name == per for r in recs)
    if n == 0:
        return None
    tags = None if within is None else {r.tag for r in recs if r.name == within}
    idle = idle_us(ctx.trace, recs)
    total = sum(us for r, us in zip(recs, idle)
                if r.name in phases and (tags is None or r.tag in tags))
    return total * 1e-3 / n


def self_us(recs: list[Placed]) -> list[float]:
    """Per record, its duration less the part its children cover (they nest)."""
    own = [r.end - r.start for r in recs]
    for i, r in enumerate(recs):
        if r.parent is None:
            continue
        # the parent: the shortest record of that name that holds this one
        holders = [j for j, p in enumerate(recs) if p.name == r.parent and j != i
                   and p.start <= r.start and r.end <= p.end]
        if holders:
            own[min(holders, key=lambda j: recs[j].end - recs[j].start)] -= r.end - r.start
    return own


UNITS = ("train.step", "eval.batch", "eval.pass", "encode.batch", "encode.pass")


def report(ctx) -> dict:
    """Every program span's device idle and host self time (ms) per unit of
    work, by the unit (the named span whose tag it shares), and the idle the
    program's spans name inside the benchmark's `step` and `pass` spans."""
    from .trace import breakdown

    recs = placed(ctx)
    if recs is None:
        return {}
    idle, own = idle_us(ctx.trace, recs), self_us(recs)
    unit_of = {r.tag: r.name for r in recs if r.name in UNITS}
    counts = defaultdict(int)
    for r in recs:
        if r.name in UNITS:
            counts[r.name] += 1
    table: dict[str, dict[str, dict[str, float]]] = defaultdict(lambda: defaultdict(
        lambda: {"idle_ms": 0.0, "self_ms": 0.0, "count": 0}))
    for r, i_us, s_us in zip(recs, idle, own):
        unit = unit_of.get(r.tag, "none")
        row = table[unit][r.name]
        row["idle_ms"] += i_us * 1e-3
        row["self_ms"] += s_us * 1e-3
        row["count"] += 1
    per_unit = {u: {name: {k: (v / counts[u] if k != "count" else v) for k, v in row.items()}
                    for name, row in rows.items()} for u, rows in table.items() if counts.get(u)}
    bench_idle = {k: v * 1e3 for k, v in breakdown(ctx.trace, top=50)["idle_gaps"]}
    named = {u: sum(row["idle_ms"] for row in table[u].values()) for u in table}
    return {"units": dict(counts), "per_unit": per_unit, "idle_named_ms": named,
            "benchmark_idle_ms": bench_idle, "benchmark_spans": _named_share(ctx.trace, recs),
            "clock_drift_us": ctx.trace.info.get("clock_drift_us")}


def _named_share(trace, recs: list[Placed]) -> list[list]:
    """[name, idle ms, idle ms under a program span] for each of the
    benchmark's spans in the traced window."""
    start, end = trace.window
    gaps, t = [], start
    for a, b in busy_intervals(trace.ops, start, end) + [(end, end)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)

    def idle(a: float, b: float) -> float:
        return sum(max(0.0, min(b, g1) - max(a, g0)) for g0, g1 in gaps)

    tops = [r for r in recs if r.parent is None]
    return [[n, idle(a, b) * 1e-3,
             sum(idle(max(a, r.start), min(b, r.end)) for r in tops if r.start < b and r.end > a)
             * 1e-3] for n, a, b in trace.spans]


def sync_slack(ctx) -> dict:
    """For each span that ends in a synchronisation (the benchmark's `drain`,
    the program's `host_read` and `host_copy`), its placed end less the end of
    the last device operation that started before that end. Such a span
    launches nothing after its synchronize, which returns only once every
    kernel launched before it has ended: a negative reading means the spans
    are placed early by at least that much."""
    recs = placed(ctx) or []
    syncs = [(n, b) for n, a, b in ctx.trace.spans if n == "drain"]
    syncs += [(r.name, r.end) for r in recs if r.name in ("host_read", "host_copy")]
    out = defaultdict(list)
    for name, b in syncs:
        last = max((e for _, s, e in ctx.trace.ops if s < b), default=None)
        if last is not None:
            out[name].append(round(b - last, 1))
    return dict(out)


def _span_cost(n: int = 200_000) -> dict:
    """Host microseconds per span, recording off and on."""
    import time

    from livae_tpu_torch import tracing

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = loop()
    with tracing.recording():
        on = loop()
    return {"span_off_us": off, "span_on_us": on}


def main(argv=None) -> int:
    import argparse
    import contextlib
    import json
    import os
    import sys
    import time
    from pathlib import Path
    from types import SimpleNamespace

    t0 = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recording", action="store_true",
                    help="measure four windows, recording off, on, on, off")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    os.environ["LIVAE_TORCH_BUILD_DIR"] = str(root / "livae_tpu_torch" / "_build")
    import torch
    from livae_tpu_torch import tracing

    from . import spec, trace as T
    from .harness import card

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = spec.workload(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    loop = spec.loop(traffic["loop"])
    spans = T.Spans()
    run = loop.Run(cfg, traffic, args.seed, device, spans)
    run.setup()
    windows = []
    for on in ((False, True, True, False) if args.recording else (False,)):
        with tracing.recording() if on else contextlib.nullcontext():
            res = run.window(args.seconds)
        windows.append({"recording": on, **res["metrics"]})
    print(f"is_recording under no profiler: {tracing.is_recording()}", file=sys.stderr)
    tr = run.traced()
    ctx = SimpleNamespace(cell=cell, config=cfg, traffic=traffic, spans=spans, trace=tr,
                          window=run.window_info, setup_s=time.time() - t0)
    readers = {m["name"]: spec.metric_reader(m["name"]).read(ctx)
               for m in spec.metrics_for(args.workload, "per_layer")
               if m["name"].split(".")[0] in ("extraction", "model", "optim", "engine")}
    out = {"workload": args.workload, "seed": args.seed, "card": card(device),
           "windows": windows, "readers": readers, **report(ctx), "sync_slack_us": sync_slack(ctx)}
    out.update(_span_cost())  # last: it fills the ring
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
