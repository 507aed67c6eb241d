"""Plain PyTorch pieces the reference models share: patch extraction, the
three-shear rotation, convolutions at a stated precision, and the optimizer
arithmetic. Everything computes in float32 unless a precision is asked for.

The rotation is the upstream rebuild's fast rotation (exact quarter turns
bring |phi| to pi/4, then Sx(-tan(phi/2)) Sy(sin phi) Sx(-tan(phi/2)) as
mod-P linear-interpolation shifts on a padded square canvas), written with
index gathers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

def _round8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to an 8-bit float under one per-tensor scale (amax -> the
    format's largest value), back in float32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


class _Stored8(torch.autograd.Function):
    """A tensor stored in float8 between two operations: e4m3 forward, its
    gradient e5m2 backward, each under a per-tensor scale."""

    @staticmethod
    def forward(t):
        return _round8(t, torch.float8_e4m3fn)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """An operand rounded to float8 e4m3 under a per-tensor scale; the
    gradient passes unrounded to the product's own backward."""
    t = t.float()
    with torch.no_grad():
        rounded = _round8(t, torch.float8_e4m3fn)
    return t + (rounded - t).detach()


def operands(x, w, b, precision: str):
    """(x, w, b) of a convolution as `precision` computes it: "float32"
    (with TF32 off), "bfloat16" (all three rounded and computed in bfloat16),
    "fp8" (x and w rounded to e4m3 under per-tensor scales, summed in
    float32, the result stored in bfloat16 and its gradient rounded to e5m2
    by `conv_out`)."""
    if precision == "bfloat16":
        return x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
    if precision == "fp8":
        return _fp8(x), _fp8(w), b.float()
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return x.float(), w.float(), b.float()


def io(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A tensor stored at `precision` between two operations, back in float32."""
    if precision == "float32":
        return t.float()
    if precision == "bfloat16":
        return t.to(torch.bfloat16).float()
    if precision == "fp8":
        return _Stored8.apply(t)
    raise ValueError(f"unknown precision {precision!r}")


class _Out8(torch.autograd.Function):
    """An fp8 product's output: stored in bfloat16 forward, its gradient
    rounded to e5m2 under a per-tensor scale backward (the usual fp8
    training recipe: e4m3 operands forward, e5m2 gradients backward)."""

    @staticmethod
    def forward(y):
        return y.to(torch.bfloat16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def conv_out(y: torch.Tensor, precision: str) -> torch.Tensor:
    return _Out8.apply(y) if precision == "fp8" else y


def conv2d(x, w, b, precision: str, **kw) -> torch.Tensor:
    return conv_out(F.conv2d(*operands(x, w, b, precision), **kw), precision)


def conv_transpose2d(x, w, b, precision: str, **kw) -> torch.Tensor:
    return conv_out(F.conv_transpose2d(*operands(x, w, b, precision), **kw), precision)


# --- rotation ---

def lerp_shift(v: torch.Tensor, delta: torch.Tensor, dim: int) -> torch.Tensor:
    """out[i] = (1-f) v[(i+k) mod n] + f v[(i+k+1) mod n] along `dim` of
    [B, H, W], k = floor(delta), f = delta - k; delta [B, H] along W (dim 2)
    or [B, W] along H (dim 1)."""
    n = v.shape[dim]
    k = torch.floor(delta).detach()
    f = delta - k
    ar = torch.arange(n, device=v.device)
    if dim == 2:
        i0 = torch.remainder(ar[None, None, :] + k.long()[:, :, None], n)
        f = f[:, :, None]
    else:
        i0 = torch.remainder(ar[None, :, None] + k.long()[:, None, :], n)
        f = f[:, None, :]
    i1 = torch.remainder(i0 + 1, n)
    return (1.0 - f) * torch.gather(v, dim, i0) + f * torch.gather(v, dim, i1)


def aligned_margin(size: int) -> int:
    """Canvas S + 2 (S // 4) rounded up to a multiple of 128."""
    canvas = -(-(size + 2 * (size // 4)) // 128) * 128
    return (canvas - size) // 2


def _quarter_turns(img: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate each sample's sampling grid by q x 90 degrees: R(90)[y, x] = img[x, S-1-y]."""
    turns = [img, torch.flip(img.transpose(2, 3), dims=(2,)), torch.flip(img, dims=(2, 3)),
             torch.flip(img.transpose(2, 3), dims=(3,))]
    q = torch.remainder(q.reshape(-1), 4)[:, None, None, None]
    out = img
    for i in (1, 2, 3):
        out = torch.where(q == i, turns[i], out)
    return out


def _pad(img: torch.Tensor, margin: int, mode: str) -> torch.Tensor:
    if mode == "zeros":
        return F.pad(img, (margin,) * 4)
    S = img.shape[-1]
    idx = torch.from_numpy(np.pad(np.arange(S), margin, mode="reflect")).to(img.device)
    return img.index_select(-2, idx).index_select(-1, idx)


def rotate(img: torch.Tensor, theta: torch.Tensor, mode: str = "reflection",
           margin: int | None = None) -> torch.Tensor:
    """Rotate [B, 1, S, S] by the STN convention (the sampling grid turns by
    theta [B] or [B, 1]) in float32; mode "reflection" or "zeros"."""
    B, C, S, _ = img.shape
    margin = aligned_margin(S) if margin is None else margin
    P = S + 2 * margin
    theta = theta.reshape(-1).float()
    q = torch.round(theta / (math.pi / 2.0)).detach()
    phi = theta - q * (math.pi / 2.0)
    canvas = _pad(_quarter_turns(img.float(), q.long()), margin, mode)
    pos = torch.arange(P, dtype=torch.float32, device=img.device) - (P - 1) / 2.0
    d_row = -torch.tan(phi / 2.0)[:, None] * pos[None, :]
    d_col = torch.sin(phi)[:, None] * pos[None, :]
    v = canvas.reshape(B * C, P, P)
    v = lerp_shift(lerp_shift(lerp_shift(v, d_row, 2), d_col, 1), d_row, 2)
    return v.reshape(B, C, P, P)[:, :, margin:margin + S, margin:margin + S]


def quarter_branch_distance(theta: torch.Tensor) -> torch.Tensor:
    """How far each angle lies from the nearest odd multiple of pi/4, where
    the rotation's quarter-turn choice changes."""
    phi = torch.remainder(theta.reshape(-1).double(), math.pi / 2.0)
    return (phi - math.pi / 4.0).abs()


# --- extraction ---

def _axis_resample(x, src, dim: int):
    n = x.shape[dim]
    i0f = torch.floor(src)
    f = src - i0f
    i0 = i0f.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 <= n - 1), 1.0 - f, torch.zeros_like(f))
    w1 = torch.where((i1 >= 0) & (i1 <= n - 1), f, torch.zeros_like(f))
    i0, i1 = torch.clamp(i0, 0, n - 1), torch.clamp(i1, 0, n - 1)
    if dim == 1:
        idx0, idx1 = (i[:, :, None].expand(-1, -1, x.shape[2]) for i in (i0, i1))
        w0, w1 = w0[:, :, None], w1[:, :, None]
    else:
        idx0, idx1 = (i[:, None, :].expand(-1, x.shape[1], -1) for i in (i0, i1))
        w0, w1 = w0[:, None, :], w1[:, None, :]
    return torch.gather(x, dim, idx0) * w0 + torch.gather(x, dim, idx1) * w1


def _minmax(p: torch.Tensor) -> torch.Tensor:
    mn = p.amin(dim=(1, 2), keepdim=True)
    rng = p.amax(dim=(1, 2), keepdim=True) - mn
    pos = rng > 0
    return torch.where(pos, (p - mn) / torch.where(pos, rng, torch.ones_like(rng)),
                       torch.zeros_like(p))


def _crop(p: torch.Tensor, size: int) -> torch.Tensor:
    top = int(round((p.shape[1] - size) / 2.0))
    return p[:, top:top + size, top:top + size]


def extract(frames: torch.Tensor, img_idx: torch.Tensor, centers: torch.Tensor,
            patch: int, padding: int, draws: dict | None, normalize: bool = True,
            paired: bool = False, io_precision: str = "float32"):
    """Patches [B, 1, patch, patch] around sites (y, x) of the normalised
    frames [N, H, W]: a (patch + 2 padding + 16) crop about the rounded
    centre, a separable bilinear resample onto (patch + 2 padding) that puts
    the site at its centre, scaled by draws["scale"], the flips and the roll
    jitter folded in; centre crop; per-patch min-max. With `paired`, also
    the padded patch rotated by draws["angle"] on a zero canvas (margin
    P2 // 6), its input and output stored at `io_precision`, cropped and
    normalised on its own: (patch, rotated, angle)."""
    B = img_idx.shape[0]
    dev = frames.device
    P2 = patch + 2 * padding
    roi = P2 + 16
    margin = roi // 2 + 8
    fp = F.pad(frames, (margin,) * 4)
    cy, cx = centers[:, 0].float(), centers[:, 1].float()
    yi, xi = torch.round(cy).long(), torch.round(cx).long()
    y0 = torch.clamp(yi - roi // 2 + margin, 0, fp.shape[1] - roi)
    x0 = torch.clamp(xi - roi // 2 + margin, 0, fp.shape[2] - roi)
    ry, rx = cy - (yi - roi // 2).float(), cx - (xi - roi // 2).float()
    ar = torch.arange(roi, device=dev)
    rois = fp[img_idx[:, None, None], (y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]
    if draws is None:
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        zero = torch.zeros(B, dtype=torch.long, device=dev)
        draws = dict(scale=torch.ones(B, device=dev), flip_h=no, flip_v=no, jy=zero, jx=zero)
    grid = torch.arange(P2, device=dev)[None, :]

    def src(r, flip, j):
        m = torch.remainder(grid - j[:, None], P2)
        m = torch.where(flip[:, None], P2 - 1 - m, m)
        return (m.float() - P2 / 2.0) / draws["scale"][:, None] + r[:, None]

    big = _axis_resample(rois, src(ry, draws["flip_v"], draws["jy"]), 1)
    big = _axis_resample(big, src(rx, draws["flip_h"], draws["jx"]), 2)
    x = _crop(big, patch)
    x = (_minmax(x) if normalize else x)[:, None]
    if not paired:
        return x
    rot = io(rotate(io(big[:, None], io_precision), draws["angle"], "zeros", P2 // 6),
             io_precision)[:, 0]
    rot = _crop(rot, patch)
    return x, (_minmax(rot) if normalize else rot)[:, None], draws["angle"]


# --- optimizer arithmetic ---

def clip_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale grads in place by min(1, max_norm / max(norm, 1e-12)); return the norm."""
    norm = torch.sqrt(sum(torch.sum(g.double() * g.double()) for g in grads)).float()
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def adam_step_(params: dict, grads: dict, state: dict, lr: float, t: int,
               weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam step (AdamW's decoupled decay where weight_decay > 0) at step
    count t (1 for the first), in place."""
    b1, b2 = betas
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        if weight_decay:
            p.mul_(1 - lr * weight_decay)
        denom = v.sqrt() / math.sqrt(1 - b2 ** t) + eps
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def cosine_lr(lr: float, total: int, count: int) -> float:
    """Cosine annealing from lr to 0 over `total` steps."""
    c = min(count, total)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / max(total, 1)))


def cosine_restarts_lr(lr: float, t0: int, t_mult: int, count: int) -> float:
    """Cosine warm restarts: periods t0, t0 t_mult, ..."""
    start, t = 0, max(t0, 1)
    while count >= start + t:
        start += t
        t *= t_mult
    return cosine_lr(lr, t, count - start)
