"""The vmap rules of the kernels' autograd Functions, on the CPU.

`Rot3Function` and `FractionalShiftFunction` launch CUDA kernels; here their
`_launch_fwd` / `_launch_bwd` are replaced by the plain versions (the forward
by `rot3_reference` / `fractional_shift_reference`, the backward by autograd
through it / `fractional_shift_vjp_reference`), and the Functions are called
directly (`rot3()` and `fractional_shift()` send CPU tensors to the plain
versions and would bypass them). Under `torch.func.vmap` with plain autograd
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
