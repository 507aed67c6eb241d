"""The program's spans placed on a made-up trace: the benchmark's offset,
each idle gap given to the innermost program span, the seven readers; and
None where there is no device or no tracer."""

import builtins
from types import SimpleNamespace

import pytest

from livae_tpu_torch import tracing
from portbench import program_spans as ps, spec
from portbench.trace import Spans, Trace

OFFSET = 1_000.0  # us: the trace's clock less the host's
READERS = ["extraction.idle_ms_per_step.train", "model.idle_ms_per_step.train",
           "optim.idle_ms_per_step.train", "engine.idle_ms_per_step.train",
           "extraction.idle_ms_per_batch.encode", "model.idle_ms_per_batch.encode",
           "engine.idle_ms_per_pass.encode"]


def _rec(name, a, b, parent, tag):
    """A program record at host microseconds a..b (the ring keeps nanoseconds)."""
    return tracing.Record(name, int(a * 1e3), int(b * 1e3), parent, tag)


def _ctx(records, monkeypatch, ops=None):
    """A benchmark `step` span over host 0..100 us, placed at OFFSET, with
    set-up spans before it; the program's records; device ops (trace clock)."""
    spans = Spans()
    spans.done = [("start", -50e-6, -40e-6), ("step", 0.0, 100e-6), ("drain", 100e-6, 110e-6)]
    t = Trace()
    t.spans = [(n, a * 1e6 + OFFSET, b * 1e6 + OFFSET) for n, a, b in spans.done[1:]]
    t.ops = ops if ops is not None else [
        ("k1", OFFSET + 5, OFFSET + 20),    # gaps: 0-5 under train.step's own time,
        ("k2", OFFSET + 30, OFFSET + 40),   # 20-30: extract 20-25, its crop 25-30,
        ("k3", OFFSET + 60, OFFSET + 105),  # 40-60: forward 40-50, backward 50-55, clip 55-60,
    ]                                       # 105-110: after the step, under no program span
    monkeypatch.setattr(tracing, "records", lambda: records)
    return SimpleNamespace(trace=t, spans=spans)


STEP = [_rec("train.step", 0, 100, None, 7), _rec("draws", 1, 20, "train.step", 7),
        _rec("extract", 20, 30, "train.step", 7), _rec("crop", 25, 30, "extract", 7),
        _rec("forward", 40, 50, "train.step", 7), _rec("backward", 50, 55, "train.step", 7),
        _rec("clip", 55, 60, "train.step", 7), _rec("metrics", 90, 95, "train.step", 7),
        _rec("early", -45, -41, None, 3)]  # a set-up record: outside the traced window


def test_offset_from_the_benchmark_spans(monkeypatch):
    ctx = _ctx(STEP, monkeypatch)
    assert ps.offset_us(ctx) == pytest.approx(OFFSET)
    recs = ps.placed(ctx)
    assert [r.name for r in recs] == [r.name for r in STEP[:-1]]
    assert recs[0].start == pytest.approx(OFFSET) and recs[0].end == pytest.approx(OFFSET + 100)


def test_idle_goes_to_the_innermost_span(monkeypatch):
    ctx = _ctx(STEP, monkeypatch)
    recs = ps.placed(ctx)
    got = dict(zip((r.name for r in recs), ps.idle_us(ctx.trace, recs)))
    want = {"train.step": 1.0, "draws": 4.0, "extract": 5.0, "crop": 5.0, "forward": 10.0,
            "backward": 5.0, "clip": 5.0, "metrics": 0.0}
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(35.0)  # the idle inside `step` (0-5, 20-30, 40-60)


def test_train_readers(monkeypatch):
    ctx = _ctx(STEP, monkeypatch)
    read = {n: spec.metric_reader(n).read(ctx) for n in READERS}
    assert read["extraction.idle_ms_per_step.train"] == pytest.approx(14e-3)
    assert read["model.idle_ms_per_step.train"] == pytest.approx(15e-3)
    assert read["optim.idle_ms_per_step.train"] == pytest.approx(5e-3)
    assert read["engine.idle_ms_per_step.train"] == pytest.approx(1e-3)
    assert all(read[n] is None for n in READERS if n.endswith(".encode"))


def test_encode_readers_count_batches_and_passes(monkeypatch):
    recs = [_rec("encode.pass", 0, 100, None, 1),
            _rec("encode.batch", 0, 45, "encode.pass", 2), _rec("indices", 0, 10, "encode.batch", 2),
            _rec("extract", 10, 25, "encode.batch", 2), _rec("forward", 25, 45, "encode.batch", 2),
            _rec("encode.batch", 45, 90, "encode.pass", 3), _rec("indices", 45, 50, "encode.batch", 3),
            _rec("extract", 50, 60, "encode.batch", 3), _rec("forward", 60, 90, "encode.batch", 3),
            _rec("host_copy", 90, 100, "encode.pass", 1)]
    ctx = _ctx(recs, monkeypatch)
    read = {n: spec.metric_reader(n).read(ctx) for n in READERS}
    # idle 0-5 (indices), 20-30 (extract 20-25, forward 25-30), 40-60 (forward 40-45,
    # batch 2's indices 45-50, extract 50-60); 2 batches, 1 pass
    assert read["extraction.idle_ms_per_batch.encode"] == pytest.approx((5 + 5 + 5 + 10) / 2e3)
    assert read["model.idle_ms_per_batch.encode"] == pytest.approx((5 + 5) / 2e3)
    assert read["engine.idle_ms_per_pass.encode"] == pytest.approx(0.0)
    assert all(read[n] is None for n in READERS if n.endswith(".train"))


def test_readers_return_nothing_without_a_device(monkeypatch):
    ctx = _ctx(STEP, monkeypatch, ops=[])
    assert all(spec.metric_reader(n).read(ctx) is None for n in READERS)


def test_readers_return_nothing_without_the_tracer(monkeypatch):
    """A program that has no tracing module (an older commit) gives None."""
    ctx = _ctx(STEP, monkeypatch)
    real = builtins.__import__

    def no_tracer(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "livae_tpu_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("no tracing module")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert all(spec.metric_reader(n).read(ctx) is None for n in READERS)


def test_report_gives_idle_and_self_time_per_unit(monkeypatch):
    out = ps.report(_ctx(STEP, monkeypatch))
    assert out["units"] == {"train.step": 1}
    step = out["per_unit"]["train.step"]
    assert step["extract"]["self_ms"] == pytest.approx(5e-3)  # 10 us less its crop's 5
    assert step["train.step"]["self_ms"] == pytest.approx((100 - 19 - 10 - 10 - 5 - 5 - 5) * 1e-3)
    assert out["idle_named_ms"]["train.step"] == pytest.approx(35e-3)
    assert out["benchmark_idle_ms"]["step"] == pytest.approx(35e-3)
    # the benchmark's step: 35 us idle, all under the program's train.step; its drain: 5, none
    assert out["benchmark_spans"] == [["step", pytest.approx(35e-3), pytest.approx(35e-3)],
                                      ["drain", pytest.approx(5e-3), pytest.approx(0.0)]]
