"""The vmap rules of the kernels' autograd Functions, on the CPU.

`Rot3Function`, `FractionalShiftFunction`, `UpconvFunction` and
`PhaseMaxFunction` launch CUDA kernels; here their `_launch_*` functions are
replaced by the plain versions (the forward by `rot3_reference` /
`fractional_shift_reference` / `upconv_epilogue_reference` /
`phase_max_reference`, the backward by autograd through it or the plain VJP),
and the Functions are called directly (the dispatching wrappers send CPU
tensors to the plain versions and would bypass them). The upconv Functions'
weights and biases are per lane: two lanes with their own, alone and inside
the decoder and the STN of two RVAEs. Under `torch.func.vmap` with plain autograd
outside it: the outputs and gradients equal the plain version lane by lane
(bit-equal: the same operations on the same values, tolerance 0), the patched
launch runs once on the folded batch, and `needs_input_grad` still picks the
dx-free backward where x needs no gradient.
"""

import numpy as np
import pytest
import torch

from livae_tpu_torch.ops import rot3 as R
from livae_tpu_torch.ops import shear as SH

K, B, P = 3, 2, 12


@pytest.fixture
def launches(monkeypatch):
    """The launches' shapes, with the plain versions in place of the kernels."""
    calls = []

    def rot3_fwd(x, d_row, d_col, cluster=None):
        calls.append(("rot3_fwd", tuple(x.shape)))
        return R.rot3_reference(x, d_row, d_col)

    def rot3_bwd(x, d_row, d_col, g, with_dx=True, cluster=None):
        calls.append(("rot3_bwd", tuple(x.shape), with_dx))
        ins = [t.detach().requires_grad_(True) for t in (x, d_row, d_col)]
        with torch.enable_grad():
            dx, ddr, ddc = torch.autograd.grad(R.rot3_reference(*ins), ins, g)
        return (dx if with_dx else None), ddr, ddc

    def shear_fwd(x, delta, axis, plan=None):
        calls.append(("shear_fwd", tuple(x.shape)))
        return SH.fractional_shift_reference(x, delta, axis)

    def shear_bwd(x, delta, g, axis, with_dx=True, plan=None):
        calls.append(("shear_bwd", tuple(x.shape), with_dx))
        dx, ddelta = SH.fractional_shift_vjp_reference(x, delta, g, axis)
        return (dx if with_dx else None), ddelta

    monkeypatch.setattr(R, "_launch_fwd", rot3_fwd)
    monkeypatch.setattr(R, "_launch_bwd", rot3_bwd)
    monkeypatch.setattr(SH, "_launch_fwd", shear_fwd)
    monkeypatch.setattr(SH, "_launch_bwd", shear_bwd)
    return calls


def _tensors(rng, *shapes):
    return [torch.from_numpy((rng.standard_normal(s) * 3).astype(np.float32)) for s in shapes]


def _grads(out, w, ins):
    return torch.autograd.grad((out.float() * w).sum(), [t for t in ins if t.requires_grad])


@pytest.mark.parametrize("x_grad", [True, False], ids=["dx", "dx_free"])
@pytest.mark.parametrize("x_shared", [False, True], ids=["x_per_lane", "x_shared"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rot3_vmap_rule_folds_the_lanes(rng, launches, x_grad, x_shared, dtype):
    x, d_row, d_col, w = _tensors(rng, (B, P, P) if x_shared else (K, B, P, P), (K, B, P),
                                  (K, B, P), (K, B, P, P))
    x = x.to(dtype).requires_grad_(x_grad)
    d_row.requires_grad_(True)
    d_col.requires_grad_(True)
    out = torch.func.vmap(R.Rot3Function.apply, in_dims=(None if x_shared else 0, 0, 0))(
        x, d_row, d_col)
    got = _grads(out, w, (x, d_row, d_col))
    assert launches == [("rot3_fwd", (K * B, P, P)), ("rot3_bwd", (K * B, P, P), x_grad)]

    # the plain version lane by lane; a shared x's gradient is the sum of the
    # lanes' dx over the lane axis, as the expand's backward takes it
    xs = x.detach().expand(K, *x.shape[-3:]) if x_shared else x.detach()
    ins = [t.detach().clone().requires_grad_(r) for t, r in
           ((xs, x_grad), (d_row, True), (d_col, True))]
    want = torch.stack([R.rot3_reference(ins[0][k], ins[1][k], ins[2][k]) for k in range(K)])
    assert out.dtype == dtype and torch.equal(out, want)
    want_grads = list(_grads(want, w, ins))
    if x_shared and x_grad:
        want_grads[0] = want_grads[0].sum(0)
    for a, b in zip(got, want_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("x_grad", [True, False], ids=["dx", "dx_free"])
def test_shear_vmap_rule_folds_the_lanes(rng, launches, axis, x_grad):
    H, W = P, P + 4
    x, delta, w = _tensors(rng, (K, B, H, W), (K, B, W if axis == 1 else H), (K, B, H, W))
    x.requires_grad_(x_grad)
    delta.requires_grad_(True)
    out = torch.func.vmap(SH.FractionalShiftFunction.apply, in_dims=(0, 0, None))(x, delta, axis)
    got = _grads(out, w, (x, delta))
    assert launches == [("shear_fwd", (K * B, H, W)), ("shear_bwd", (K * B, H, W), x_grad)]

    lanes = [SH.fractional_shift_vjp_reference(x[k].detach(), delta[k].detach(), w[k], axis)
             for k in range(K)]
    want = torch.stack([SH.fractional_shift_reference(x[k].detach(), delta[k].detach(), axis)
                        for k in range(K)])
    assert torch.equal(out, want)
    want_grads = ([torch.stack([dx for dx, _ in lanes])] if x_grad else []) + \
        [torch.stack([dd for _, dd in lanes])]
    for a, b in zip(got, want_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rule_outside_vmap_is_one_plain_launch(rng, launches):
    """A call outside vmap does not touch the rule: one launch on its batch."""
    x, d_row, d_col = _tensors(rng, (B, P, P), (B, P), (B, P))
    out = R.Rot3Function.apply(x, d_row.requires_grad_(True), d_col)
    out.sum().backward()
    assert launches == [("rot3_fwd", (B, P, P)), ("rot3_bwd", (B, P, P), False)]
    assert torch.equal(out, R.rot3_reference(x, d_row, d_col))


def test_fold_lanes_expands_shared_inputs():
    a = torch.arange(6.0).reshape(2, 3)
    b = torch.arange(12.0).reshape(3, 2, 2).movedim(0, 1)  # lanes on dim 1
    fa, fb = SH.fold_lanes(3, (None, 1), a, b)
    assert fa.shape == (6, 3) and fa.is_contiguous() and torch.equal(fa[4:], a)
    assert fb.shape == (6, 2) and torch.equal(fb.reshape(3, 2, 2), b.movedim(1, 0))


@pytest.fixture
def up_launches(monkeypatch):
    """The upconv kernels' launches (shapes, the bias's lanes), with the plain
    versions in place of the kernels."""
    from livae_tpu_torch.ops import upconv as U

    calls = []

    def ufwd(y, qr, qc, bias, relu):
        calls.append(("upconv_fwd", tuple(y.shape), tuple(bias.shape)))
        return U.upconv_epilogue_reference(y, qr, qc, bias, relu)

    def ubwd(g, out):
        calls.append(("upconv_bwd", tuple(g.shape)))
        return U.upconv_epilogue_vjp_reference(g, out)

    def pfwd(y, bias):
        calls.append(("phasemax_fwd", tuple(y.shape), tuple(bias.shape)))
        out, win = U.phase_max_reference(y, bias)
        return out.detach(), win

    def pbwd(g, win):
        calls.append(("phasemax_bwd", tuple(g.shape)))
        return U.phase_max_vjp_reference(g, win)

    monkeypatch.setattr(U, "_launch_upconv_fwd", ufwd)
    monkeypatch.setattr(U, "_launch_upconv_bwd", ubwd)
    monkeypatch.setattr(U, "_launch_pmax_fwd", pfwd)
    monkeypatch.setattr(U, "_launch_pmax_bwd", pbwd)
    return calls


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_upconv_vmap_rule_folds_per_lane_weights(rng, up_launches, relu):
    """Two lanes with their own phase maps, edge lines and bias: one launch on
    the folded batch with a bias row per lane; outputs and gradients those of
    each lane alone (the bias's gradient sums in another order: 1e-6)."""
    from livae_tpu_torch.ops import upconv as U

    K, B, C, H, W = 2, 2, 3, 2, 3
    y, qr, qc, bias, w = _tensors(rng, (K, B, 4 * C, H, W), (K, B, 6 * C, 2, W),
                                  (K, B, 6 * C, H, 2), (K, C), (K, B, C, 2 * H, 2 * W))
    ins = [t.requires_grad_(True) for t in (y, qr, qc, bias)]
    out = torch.func.vmap(lambda *a: U.UpconvFunction.apply(*a[:3], a[3].reshape(1, C), relu))(*ins)
    got = _grads(out, w, ins)
    assert up_launches == [("upconv_fwd", (K * B, 4 * C, H, W), (K, C)),
                           ("upconv_bwd", (K * B, C, 2 * H, 2 * W))]
    lanes = [[t[k].detach().clone().requires_grad_(True) for t in ins] for k in range(K)]
    want = torch.stack([U.upconv_epilogue_reference(*lane, relu) for lane in lanes])
    assert torch.equal(out, want)
    want_grads = [torch.stack(g) for g in zip(*[_grads(want[k], w[k], lanes[k])
                                                 for k in range(K)])]
    for a, b in zip(got, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_phasemax_vmap_rule_folds_per_lane_bias(rng, up_launches):
    from livae_tpu_torch.ops import upconv as U

    K, B, C, h, w = 2, 3, 2, 2, 3
    y, bias, cot = _tensors(rng, (K, B, 4 * C, h, w), (K, C), (K, B, C, h, w))
    y, bias = y.requires_grad_(True), bias.requires_grad_(True)
    out = torch.func.vmap(lambda a, b: U.PhaseMaxFunction.apply(a, b.reshape(1, C))[0])(y, bias)
    got = _grads(out, cot, (y, bias))
    assert up_launches == [("phasemax_fwd", (K * B, 4 * C, h, w), (K, C)),
                           ("phasemax_bwd", (K * B, C, h, w))]
    lanes = [[t[k].detach().clone().requires_grad_(True) for t in (y, bias)] for k in range(K)]
    want = torch.stack([U.phase_max_reference(*lane)[0] for lane in lanes])
    assert torch.equal(out, want)
    want_grads = [torch.stack(g) for g in zip(*[_grads(want[k], cot[k], lanes[k])
                                                 for k in range(K)])]
    torch.testing.assert_close(got[0], want_grads[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want_grads[1], rtol=1e-6, atol=1e-6)


def test_decoder_and_stn_fold_two_lanes_with_their_own_weights(rng, up_launches, monkeypatch):
    """The stacked trials' form: two RVAEs of other seeds as two lanes of one
    vmapped functional_call, with the Functions (and their vmap rules) in place
    of the CPU's plain path: the decoder launches U 4 times and the STN P twice,
    each on the folded lanes, and every lane's outputs and weight gradients are
    its own model's (1e-5: the bias gradients sum in another order)."""
    from torch.func import functional_call

    from livae_tpu_torch.models.rvae import RVAE
    from livae_tpu_torch.ops import upconv as U

    K, B, latent, patch = 2, 2, 8, 32
    models = [RVAE(latent, 1, patch, device="cpu", generator=torch.Generator().manual_seed(s))
              for s in (3, 4)]
    z, x = _tensors(rng, (K, B, latent), (K, B, 1, patch, patch))

    def passes(model, params, z, x):
        """The decoder, and the STN's two localisation blocks."""
        recon = functional_call(model.decoder, params["decoder"], (z,))
        loc = model.encoder.rotation_stn.localization
        h = functional_call(loc[0], params["loc0"], (x,))
        h = functional_call(loc[3], params["loc3"], (h,))
        return recon, h

    def split(m):
        p = dict(m.named_parameters())
        pick = lambda pre: {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
        return {"decoder": pick("decoder."), "loc0": pick("encoder.rotation_stn.localization.0."),
                "loc3": pick("encoder.rotation_stn.localization.3.")}

    want, want_grads = [], []
    for k, m in enumerate(models):  # each lane alone, the CPU's plain path
        params = split(m)
        recon, h = passes(m, params, z[k], x[k])
        leaves = [v for d in params.values() for v in d.values()]
        want.append((recon, h))
        want_grads.append(torch.autograd.grad(recon.sum() + h.sum(), leaves))

    monkeypatch.setattr(U, "upconv_epilogue", lambda y, qr, qc, b, relu=False: U.UpconvFunction
                        .apply(y, qr, qc, b.reshape(-1, y.shape[1] // 4), relu))
    monkeypatch.setattr(U, "phase_max", lambda y, b: U.PhaseMaxFunction.apply(
        y, b.reshape(-1, y.shape[1] // 4))[0])
    stacked = {name: {k: torch.stack([split(m)[name][k].detach() for m in models])
                      .requires_grad_(True) for k in split(models[0])[name]}
               for name in ("decoder", "loc0", "loc3")}
    recon, h = torch.func.vmap(lambda p, a, b: passes(models[0], p, a, b))(stacked, z, x)
    leaves = [v for d in stacked.values() for v in d.values()]
    got_grads = torch.autograd.grad(recon.sum() + h.sum(), leaves)
    names = [c[0] for c in up_launches]
    assert names.count("upconv_fwd") == 4 and names.count("phasemax_fwd") == 2
    assert names.count("upconv_bwd") == 4 and names.count("phasemax_bwd") == 2
    assert all(c[1][0] == K * B for c in up_launches)
    assert all(c[2][0] == K for c in up_launches if c[0].endswith("fwd"))
    for k in range(K):
        torch.testing.assert_close(recon[k], want[k][0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(h[k], want[k][1], rtol=1e-5, atol=1e-6)
        for a, b in zip(got_grads, want_grads[k]):
            torch.testing.assert_close(a[k], b, rtol=1e-5, atol=1e-5)
