"""The program's spans and counters (livae_tpu_torch.tracing) on the CPU.

A fused rVAE step, a VAE step, the evals and a `collect_stats` pass, run
under `recording()`, give the span tree the benchmark's readers rely on
(names, parents, one tag per step or batch); with recording off they leave
no record; their outputs are bit-equal either way. The counters replace the
kernels' launch globals: `kernel_launches()` reads them under its old keys.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from livae_tpu_torch import tracing
from livae_tpu_torch.data.datasets import AdaptiveLatticeDataset
from livae_tpu_torch.data.pipeline import AugmentConfig
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.scripts import visualizations
from livae_tpu_torch.scripts._common import KERNELS, kernel_launches
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train.state import make_optimizer

PATCH, LATENT, PAD, B, STEPS = 32, 8, 8, 8, 2
MARGIN = (PATCH + 2 * PAD + 16) // 2 + 8
STEP_CHILDREN = ["draws", "extract", "forward", "loss", "backward", "clip", "optimizer", "metrics"]
EVAL_CHILDREN = ["draws", "extract", "forward", "metrics"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def table(rng):
    """Two random frames and 40 sites: the padded frames, image indices, centres."""
    N, H, W, n = 2, 120, 140, 40
    raw = rng.random((N, H, W)).astype(np.float32)
    coords = np.stack([rng.uniform(20, H - 20, n), rng.uniform(20, W - 20, n)], 1)
    img_idx = rng.integers(0, N, n)
    return (torch.nn.functional.pad(torch.from_numpy(raw), (MARGIN,) * 4),
            torch.from_numpy(img_idx).long(), torch.from_numpy(coords.astype(np.float32)))


def _recorded(fn):
    """fn()'s result and the records it left, recording on."""
    n = len(tracing.records())
    with tracing.recording():
        out = fn()
    return out, tracing.records()[n:]


def _unrecorded(fn):
    """fn()'s result, recording off; it must leave no record."""
    assert not tracing.is_recording()
    n = len(tracing.records())
    out = fn()
    assert len(tracing.records()) == n
    return out


def _children(recs, parent, tag):
    return [r.name for r in sorted(recs, key=lambda r: r.start)
            if r.parent == parent and r.tag == tag]


def _assert_nested(recs):
    """Each record lies inside a record of its parent's name and tag."""
    for r in recs:
        if r.parent is not None:
            assert any(p.name == r.parent and p.start <= r.start and r.end <= p.end
                       and (p.tag == r.tag or p.name.endswith(".pass")) for p in recs), r


def _train(kind, table, rng):
    """A function that builds the kind's model and fused step from fixed
    weights and runs STEPS steps with given draws and noise: (metrics, weights)."""
    idx = torch.from_numpy(rng.permutation(40)[: STEPS * B].reshape(STEPS, B))
    gen = torch.Generator().manual_seed(1)
    draws = [te.sample_paired_draws(B, AugmentConfig(), gen, "cpu") for _ in range(STEPS)]
    eps = [torch.randn((B, LATENT), generator=gen) for _ in range(STEPS)]
    state = (RVAE if kind == "rvae" else VAE)(
        LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()

    def run():
        model = (RVAE if kind == "rvae" else VAE)(LATENT, 1, PATCH, device="cpu")
        model.load_state_dict(state)
        opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
        kw = dict(patch_size=PATCH, padding=PAD, margin=MARGIN, cfg=AugmentConfig(),
                  device="cpu")
        make = te.make_fused_rvae_train_step if kind == "rvae" else te.make_fused_vae_train_step
        step = make(model, opt, **kw)
        m = step(*table, idx, None, 1.0, 1.0, draws=draws, eps=eps)
        return m, model.state_dict()

    return run


@pytest.mark.parametrize("kind", ["rvae", "vae"])
def test_fused_train_step_span_tree(kind, table, rng):
    run = _train(kind, table, rng)
    (m_on, w_on), recs = _recorded(run)
    steps = [r for r in recs if r.name == "train.step"]
    assert len(steps) == STEPS and len({r.tag for r in steps}) == STEPS
    assert all(r.parent is None for r in steps)
    extract_children = ["crop", "resample", "rotate", "normalize"] if kind == "rvae" else [
        "crop", "resample", "normalize"]
    for s in steps:
        assert _children(recs, "train.step", s.tag) == STEP_CHILDREN
        assert _children(recs, "extract", s.tag) == extract_children
        assert {r.tag for r in recs if s.start <= r.start and r.end <= s.end} == {s.tag}
    _assert_nested(recs)
    assert Counter(r.name for r in recs) == Counter(
        {"train.step": STEPS, **{n: STEPS for n in STEP_CHILDREN + extract_children}})

    m_off, w_off = _unrecorded(run)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_off)
    assert all(torch.equal(w_on[k], w_off[k]) for k in w_off)


@pytest.mark.parametrize("kind", ["rvae", "vae"])
def test_fused_eval_span_tree(kind, table, rng):
    model = (RVAE if kind == "rvae" else VAE)(LATENT, 1, PATCH, device="cpu",
                                              generator=torch.Generator().manual_seed(0))
    kw = dict(patch_size=PATCH, padding=PAD, margin=MARGIN, device="cpu")
    fused = (te.make_fused_rvae_eval(model, cfg=None, **kw) if kind == "rvae"
             else te.make_fused_eval(model, **kw))
    val_idx = rng.permutation(40)[: 2 * B + 3]  # two full batches and a tail of 3

    def run():
        return te.evaluate_fused(fused, table + (None,), val_idx, B,
                                 torch.Generator().manual_seed(2))

    on, recs = _recorded(run)
    (p,) = [r for r in recs if r.name == "eval.pass"]
    batches = [r for r in recs if r.name == "eval.batch"]
    assert len(batches) == 3 and all(b.parent == "eval.pass" for b in batches)
    assert len({b.tag for b in batches} | {p.tag}) == 4
    assert _children(recs, "eval.pass", p.tag) == ["indices", "host_read", "host_read"]
    for b in batches:
        assert _children(recs, "eval.batch", b.tag) == EVAL_CHILDREN
    _assert_nested(recs)
    assert on == _unrecorded(run)


def test_collect_stats_span_tree():
    frame, _ = synthetic_mos2_frame(size=512, spacing=40.0, seed=0)
    ds = AdaptiveLatticeDataset([frame], patch_size=PATCH, padding=PAD, transform=None,
                                device="cpu")
    model = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = 256
    n_batches = -(-len(ds) // batch)
    assert n_batches >= 2

    def run():
        return visualizations.collect_stats(model, ds, batch, True)

    on, recs = _recorded(run)
    (p,) = [r for r in recs if r.name == "encode.pass"]
    batches = [r for r in recs if r.name == "encode.batch"]
    assert len(batches) == n_batches and all(b.parent == "encode.pass" for b in batches)
    assert len({b.tag for b in batches} | {p.tag}) == n_batches + 1
    assert _children(recs, "encode.pass", p.tag) == ["host_copy"]
    for b in batches:
        assert _children(recs, "encode.batch", b.tag) == ["indices", "extract", "forward"]
        assert _children(recs, "extract", b.tag) == ["crop", "resample", "normalize"]
    _assert_nested(recs)
    off = _unrecorded(run)
    for a, b in zip(on[:3], off[:3]):
        np.testing.assert_array_equal(a, b)
    assert on[3] == off[3]


def test_span_off_is_one_shared_context():
    assert not tracing.is_recording()
    a, b = tracing.span("x"), tracing.span("y", new_tag=True)
    assert a is b
    n = len(tracing.records())
    with a:
        pass
    assert len(tracing.records()) == n


def test_tags_parents_and_clock():
    t0 = __import__("time").perf_counter_ns()
    with tracing.recording():
        with tracing.span("outer", new_tag=True):
            with tracing.span("inner"):
                pass
            with tracing.span("unit", new_tag=True):
                with tracing.span("leaf"):
                    pass
    inner, leaf, unit, outer = tracing.records()[-4:]
    assert [r.name for r in (inner, leaf, unit, outer)] == ["inner", "leaf", "unit", "outer"]
    assert (inner.parent, unit.parent, leaf.parent, outer.parent) == ("outer", "outer", "unit",
                                                                       None)
    assert inner.tag == outer.tag != unit.tag == leaf.tag
    assert t0 <= outer.start <= inner.start <= inner.end <= unit.start <= outer.end


def test_ring_is_bounded():
    assert tracing._ring.maxlen == tracing.RING_LENGTH
    with tracing.recording():
        for _ in range(tracing.RING_LENGTH + 5):
            with tracing.span("s"):
                pass
    assert len(tracing.records()) == tracing.RING_LENGTH


def test_a_profiler_turns_recording_on_and_ranges_reach_its_trace():
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.is_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.is_recording()
        with tracing.span("plain"):
            torch.ones(2).sum()
        with tracing.recording(ranges=True), tracing.span("ranged"):
            torch.ones(2).sum()
    assert not tracing.is_recording()
    names = {e.name for e in prof.events()}
    assert "ranged" in names and "plain" not in names
    assert [r.name for r in tracing.records()[-2:]] == ["plain", "ranged"]


def test_counters_replace_the_launch_globals():
    before = tracing.counters()
    tracing.count("rot3_fwd", 3)
    tracing.count("upconv_fwd vector")
    got = kernel_launches()
    assert tuple(got) == KERNELS
    assert got["rot3_fwd"] == before.get("rot3_fwd", 0) + 3
    assert tracing.counters()["upconv_fwd vector"] == before.get("upconv_fwd vector", 0) + 1
    tracing.reset()
    assert tracing.counters() == {} and tracing.records() == []
    assert kernel_launches() == dict.fromkeys(KERNELS, 0)
