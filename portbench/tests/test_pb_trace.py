"""Percentiles, the idle share, the breakdown and the per-layer readers on a
synthetic trace."""

from types import SimpleNamespace

import pytest

from portbench import readers, spec
from portbench.loops.common import percentile, stream_seed
from portbench.trace import Trace, breakdown, busy_intervals, busy_us


def _trace():
    t = Trace()
    t.spans = [("step", 0.0, 40.0), ("step", 40.0, 80.0), ("drain", 80.0, 100.0),
               ("host_read", 100.0, 110.0), ("eval", 110.0, 200.0)]
    # kernels (us); two overlap; a copy; one eval kernel
    t.ops = [("k_a", 5.0, 25.0), ("k_b", 20.0, 30.0), ("Memcpy HtoD", 30.0, 35.0),
             ("void rot3_fwd_kernel<4>(float)", 45.0, 85.0), ("k_eval", 150.0, 190.0)]
    t.info = {"steps": 2, "batch": 512, "eval_batches": [512]}
    return t


def test_percentile_is_linear_between_ranks():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_busy_and_idle():
    t = _trace()
    assert busy_intervals(t.ops, 0, 200) == [(5.0, 35.0), (45.0, 85.0), (150.0, 190.0)]
    assert busy_us(t) == 110.0
    assert readers.idle_pct(t) == pytest.approx(100 * (1 - 110 / 200))


def test_breakdown_attributes_gaps_to_the_open_span():
    b = breakdown(_trace())
    gaps = dict(b["idle_gaps"])
    assert gaps["step"] == pytest.approx((5 + 10) * 1e-6)
    assert gaps["drain"] == pytest.approx(15e-6)
    assert gaps["host_read"] == pytest.approx(10e-6)
    assert gaps["eval"] == pytest.approx(50e-6)
    assert b["device_ops"][0] == ["void rot3_fwd_kernel<4>(float)", pytest.approx(40e-6)]


def test_launch_reader_counts_kernels_before_the_drain_ends():
    ctx = SimpleNamespace(trace=_trace())
    assert spec.metric_reader("engine.launches_per_step.train").read(ctx) == 1.5  # 3 kernels, 2 steps


def test_roofline_reader_maps_kernel_names():
    t = _trace()
    work = [("rot3_fwd", 134_000_000)]
    # 134 MB at 3.35 TB/s = 40 us, over the 40 us of the mapped kernel
    assert readers.roofline_pct(t, work) == pytest.approx(100.0)
    assert readers.roofline_pct(t, [("upconv_fwd", 1)]) is None


def test_readers_return_nothing_without_a_device():
    t = _trace()
    t.ops = []
    ctx = SimpleNamespace(trace=t, config=spec.config("rvae128"), window={"steps": 1, "batch": 1,
                                                                          "seconds": 1.0})
    for name in ("engine.launches_per_step.train", "mfu.train", "device.idle_pct.train"):
        assert spec.metric_reader(name).read(ctx) is None


def test_seed_streams_take_large_seeds():
    a, b = stream_seed(2**31 + 5, "frame", 0), stream_seed(2**31 + 5, "frame", 1)
    assert a != b and 0 <= a < 2**63 and stream_seed(2**31 + 5, "frame", 0) == a
