"""The spatial-VAE binding and the stacked-sweep loop on the CPU at a tiny
size: each runs its cell through the harness, traced and untraced, `correct`
true, and a planted fault turns it false; the binding's FLOP counts at the
published widths; the GEMM share's reader."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, spec
from portbench.counts import ops
from portbench.tests.test_pb_loops import SEED, _half_batch, _threads, tiny  # noqa: F401
from portbench.trace import Trace

CPU = torch.device("cpu")
SPATIAL, STACKED = "spatialvae128.train-b256", "rvae128.sweep-stacked4"


@pytest.mark.parametrize("cell", [SPATIAL, STACKED])
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_cell_runs_and_is_correct(cell, traced):
    out = harness.run_cell(cell, SEED, 0.3, traced, CPU, 0.0, tiny(cell))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(spec.limits(cell))
    kind = "per_layer" if traced else "end_to_end"
    listed = {m["name"] for m in spec.metrics_for(cell, kind)}
    assert set(out["metrics"]) <= listed
    if not traced:
        assert set(out["metrics"]) == listed


def _stacked_half_batch(monkeypatch):
    """Each lane's loss taken over the first half of its batch."""
    from livae_tpu_torch.sweep import stacked

    loss = stacked._generic_loss

    def halved(model, x, beta, gamma, use_diversity, eps=None, *args, **kw):
        h = x.shape[0] // 2
        return loss(model, x[:h], beta, gamma, use_diversity, eps[:h], *args, **kw)

    monkeypatch.setattr(stacked, "_generic_loss", halved)


def _stacked_unchanged(monkeypatch):
    """The lanes' AdamW step does nothing."""
    from livae_tpu_torch.sweep import stacked

    monkeypatch.setattr(stacked, "_adamw_lanes", lambda state: None)


@pytest.mark.parametrize("cell,fault", [(SPATIAL, _half_batch), (STACKED, _stacked_half_batch),
                                        (STACKED, _stacked_unchanged)],
                         ids=["spatial-half", "stacked-half", "stacked-unchanged"])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = harness.run_cell(cell, SEED, 0.2, False, CPU, 0.0, tiny(cell))
    assert out["correct"] is False


def test_spatial_reference_sides_on_the_cpu():
    """At the tiny size in float32 the reference follows the program to
    float32 rounding; the half batch and the fp8 control read far above it."""
    cfg = {**spec.config("spatialvae128"), **tiny(SPATIAL)["config"]}
    traffic = {**spec.traffic("train-b256"), **tiny(SPATIAL)["traffic"]}
    loop = spec.loop("train")
    from portbench import trace

    run = loop.Run(cfg, traffic, SEED, CPU, trace.Spans())
    run.setup()
    sides = loop.compare(run.close(), cfg, traffic, CPU, ("program", "control", "half_batch"))
    prog = sides["program"]
    assert prog["loss_gap_step1"] < 1e-6 and prog["grad_diff_median"] < 1e-5
    for side in ("control", "half_batch"):
        assert sides[side]["loss_gap_step1"] > 100 * max(prog["loss_gap_step1"], 1e-8), side
        assert sides[side]["grad_diff_median"] > 100 * prog["grad_diff_median"], side


def test_flop_counts_at_the_published_widths():
    """A patch of 128 x 128 at H = Hq = 500, L = 2, z = 2: 16,384 pixels of
    503,000 FLOPs (2 -> 500, 500 -> 500, 500 -> 1), the latent's projection
    (2,000), the inference net's 16,384 -> 500 (16,384,000) and 500 -> 10
    (10,000); training three times that less the first inference layer's
    data gradient."""
    assert ops.forward_flops("spatialvae", 128, 2) == 8_257_548_000
    assert ops.train_flops("spatialvae", 128, 2) == 24_756_260_000
    assert ops.train_flops("spatialvae", 128, 2) == 3 * 8_257_548_000 - 16_384_000


def test_draws_are_the_augmentation_then_noise_for_z_theta_and_the_shift():
    b = spec.binding("spatialvae")
    cfg = spec.config("spatialvae128")
    d, eps = b.draws(cfg, 6, torch.Generator().manual_seed(1), CPU)
    assert eps.shape == (6, 5) and d.scale.shape == (6,)
    assert b.kernel_ops("train", cfg, 32, 256, 2) == []


def test_gemm_share_reads_the_named_matrix_products():
    reader = spec.metric_reader("model.gemm_pct.train")
    # names as the card's trace gives them (the first two) and cuBLAS's sm90 family
    ops_ = [("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_64x3_tn_"
             "align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_64x3_tn_align2::Params)",
             0.0, 10.0),
            ("void at::native::vectorized_elementwise_kernel<8, at::native::tanh_kernel_cuda>",
             10.0, 25.0),
            ("std::enable_if<true, void>::type internal::gemvx::kernel<int, int, __nv_bfloat16>",
             25.0, 30.0),
            ("void at::native::reduce_kernel<128, 4>", 30.0, 40.0),
            ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", 40.0, 50.0)]
    ctx = SimpleNamespace(trace=Trace(ops=ops_, spans=[("step", 0.0, 50.0)], info={}))
    assert reader.read(ctx) == pytest.approx(100.0 * 25.0 / 50.0)
    assert reader.read(SimpleNamespace(trace=Trace(ops=[], spans=[], info={}))) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", [SPATIAL, STACKED])
def test_half_batch_is_not_correct_on_the_card(cell):
    """Half of each batch left out (each lane's, in the stacked cell) fails
    the cell's limits at the cell's own size."""
    from portbench.tests.test_pb_loops import _side_on_the_card

    assert harness.judge(_side_on_the_card(cell, "half_batch"), spec.limits(cell))[0] is False
