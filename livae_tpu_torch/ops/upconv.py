"""The decoder stage and the STN block at half resolution (port of
livae_tpu/ops/upconv.py, NCHW, weights OIHW).

Decoder stage: Conv3x3(ReflectionPad1(Upsample2x_bilinear(x))), the
reference's checkerboard-free upsampling (src/livae/model.py:355-373). The 2x
bilinear upsample is a 2-phase linear filter, so the stage is FOUR 3x3
convolutions of the low-resolution input, one per output phase (p, q), then a
depth-to-space:

    out[2i+p, 2j+q] = sum_{s,t} Keff[p,q][s,t] . x_edge[i+s, j+t]

with Keff = A_p (x) A_q applied to the 3x3 taps (`phase_kernel`) and x_edge
the edge-replicated input. That is exact everywhere but on the outermost
output line of each side; there the exact operator adds, per axis,

    D_first = 0.25 W[-1] (x[1] - x[0])       (output line 0)
    D_last  = 0.25 W[+1] (x[n-2] - x[n-1])   (output line 2n-1)

pushed through the exact operator of the other axis, less the corner term
that both sides count (T_H T_W = A + D_H T_W + T_H D_W - D_H D_W).

* `fused_upsample_reflect_conv_reference` is the JAX package's assembly line
  for line (`_fused_1d` for each edge line, the four corners).
* `fused_upsample_reflect_conv` is the port's: the phase convolution (cuDNN
  on the card), and the edge lines' projections on the taps (`_edge_kernels`:
  two small convolutions of x's two outer row and column pairs, at stride
  n - 2, giving qr [B, 6 Cout, 2, W] and qc [B, 6 Cout, H, 2]); then `upconv_epilogue` writes
  the [B, Cout, 2H, 2W] output once: depth-to-space, bias, the corrections
  (the exact 1-D operator on the projected lines, `_line_op`) and the
  decoder's ReLU. Its plain version is `upconv_epilogue_reference`; on CUDA
  tensors `UpconvFunction` launches the kernels of ops/csrc/upconv.cu.

STN block: MaxPool2(ReLU(Conv5x5(x, pad 2))) (src/livae/model.py:203-214).
The pool reads the convolution in aligned 2x2 blocks, the four phases of a
stride-2 split, so the block is ONE 3x3 convolution of the space-to-depth
input (`space_to_depth2`, `phase_gather_5to3`: [4 Cout, 4 Cin, 3, 3]) and a
max over the four phase groups of relu(y + b) (`phase_max`). Zero padding of
the fine grid is zero padding of the phase grid: no corrections. The
cotangent goes to the FIRST maximal phase in the order (0,0), (0,1), (1,0),
(1,1), torch MaxPool2d's tie rule, through relu's zero gradient at 0.
`phase_max_reference` is the plain version; on CUDA tensors `PhaseMaxFunction`
launches the kernels and keeps the winning phase as a uint8 map (255 where
relu's gradient is 0).

Weights are cast to the compute dtype before the phase kernels are built, as
the JAX layers do; the phase kernel then rounds as JAX's einsum does (one
rounding after each of its two contractions).

`UP_FWD_LAUNCHES`, `UP_BWD_LAUNCHES`, `PMAX_FWD_LAUNCHES` and
`PMAX_BWD_LAUNCHES` count the kernels' launches; a lock keeps them exact when
several threads launch.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .shear import fold_lanes

__all__ = [
    "fused_upsample_reflect_conv",
    "fused_upsample_reflect_conv_reference",
    "fused_conv5_relu_maxpool",
    "phase_kernel",
    "upconv_epilogue",
    "upconv_epilogue_reference",
    "upconv_epilogue_vjp_reference",
    "UpconvFunction",
    "space_to_depth2",
    "phase_gather_5to3",
    "phase_max",
    "phase_max_reference",
    "phase_max_vjp_reference",
    "PhaseMaxFunction",
    "UP_FWD_LAUNCHES",
    "UP_BWD_LAUNCHES",
    "PMAX_FWD_LAUNCHES",
    "PMAX_BWD_LAUNCHES",
]

UP_FWD_LAUNCHES = 0
UP_BWD_LAUNCHES = 0
PMAX_FWD_LAUNCHES = 0
PMAX_BWD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _count_launch(name: str) -> None:
    """Add one to the launch count `name` (one of the four above)."""
    with _COUNT_LOCK:
        globals()[name] += 1


# Per-axis phase transforms A_p[s, a]: the coefficient of input tap s in
# output phase p for conv tap a (rows s = -1, 0, +1; columns a = -1, 0, +1).
_A0 = np.array([[0.75, 0.25, 0.0],
                [0.25, 0.75, 0.75],
                [0.0, 0.0, 0.25]], np.float32)
_A1 = np.array([[0.25, 0.0, 0.0],
                [0.75, 0.75, 0.25],
                [0.0, 0.25, 0.75]], np.float32)
_A = np.stack([_A0, _A1])  # [p, s, a]
_PHASE = _A.transpose(2, 0, 1).reshape(3, 6)  # [a, (p, s)]
# [(a, b), (p, s, b')]: the phase kernel's first contraction on w.view(O * I, 9)
_PHASE_ROWS = np.einsum("psa,bc->abpsc", _A, np.eye(3, dtype=np.float32)).reshape(9, 18)


def _edge_taps() -> np.ndarray:
    """[9 (tap row, tap column), 24 (side, a, r)]: w.view(O * I, 9) @ this gives
    the four edge lines' tap kernels. Sides top, bottom (a is the tap column,
    r the row of the pair x[0], x[1] or x[H-2], x[H-1]), left, right (a is the
    tap row, r the column of the pair)."""
    e = np.zeros((3, 3, 4, 3, 2), np.float32)
    for a in range(3):
        e[0, a, 0, a] = (-0.25, 0.25)  # top: 0.25 W[-1] (x[1] - x[0])
        e[2, a, 1, a] = (0.25, -0.25)  # bottom: 0.25 W[+1] (x[H-2] - x[H-1])
        e[a, 0, 2, a] = (-0.25, 0.25)  # left
        e[a, 2, 3, a] = (0.25, -0.25)  # right
    return e.reshape(9, 24)


_EDGE = _edge_taps()


def _phase_gather_matrix() -> np.ndarray:
    """[25, 144]: a 5x5 kernel flattened, times this, is the phase kernel in the
    order (p, q, pi, qi, s, t), which holds the fine tap u = 2s + pi - p,
    v = 2t + qi - q (offsets from the centre) where |u|, |v| <= 2, else 0. A
    product of 0/1 entries, one per column: exact in any float type, and its
    backward sums without atomics (an index_select's would not)."""
    g = np.zeros((25, 2, 2, 2, 2, 3, 3), np.float32)
    for p, q, pi, qi, s, t in np.ndindex(2, 2, 2, 2, 3, 3):
        u, v = 2 * (s - 1) + pi - p, 2 * (t - 1) + qi - q
        if abs(u) <= 2 and abs(v) <= 2:
            g[(u + 2) * 5 + (v + 2), p, q, pi, qi, s, t] = 1.0
    return g.reshape(25, 144)


_GATHER = _phase_gather_matrix()
_CONSTS: dict = {}


def _const(name: str, arr: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A module constant as a tensor of `dtype` on `device`, made once."""
    key = (name, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return t


# ---------------------------------------------------------------------------
# The decoder stage
# ---------------------------------------------------------------------------


def _weight_products(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w [O, I, 3, 3] times the tap rows' phase transforms and times the edge
    taps: ([O * I * 6 (p, s), 3 (b)], [O, I, 4, 3, 2]), in w's dtype."""
    O, I = w.shape[:2]
    w9 = w.reshape(O * I, 9)
    t = w9 @ _const("phase_rows", _PHASE_ROWS, w.dtype, w.device)
    e = w9 @ _const("edge", _EDGE, w.dtype, w.device)
    return t.view(O * I * 6, 3), e.view(O, I, 4, 3, 2)


def _phase_kernel(t: torch.Tensor, O: int, I: int) -> torch.Tensor:
    """The phase kernel from the first contraction t [O * I * 6 (p, s), 3 (b)]."""
    k = t @ _const("phase", _PHASE, t.dtype, t.device)  # [(o, i, p, s), (q, t)]
    return k.view(O, I, 2, 3, 2, 3).permute(2, 4, 0, 1, 3, 5).reshape(4 * O, I, 3, 3)


def _edge_kernels(e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge lines' kernels from e [O, I, 4, 3, 2]: krow [6 O, I, 2, 1]
    (channel (k, a, o), k 0 top and 1 bottom) for the row pairs (0, 1) and
    (H-2, H-1), and kcol [6 O, I, 1, 2] (k 0 left, 1 right) for the column
    pairs. Exact: each entry is +-0.25 times a tap."""
    O, I = e.shape[:2]
    krow = e[:, :, :2].permute(2, 3, 0, 1, 4).reshape(6 * O, I, 2, 1)
    kcol = e[:, :, 2:].permute(2, 3, 0, 1, 4).reshape(6 * O, I, 1, 2)
    return krow, kcol


def phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> the phase kernel [4 Cout, Cin, 3, 3], output
    channel (p * 2 + q) * Cout + o. In w's dtype, rounded after each of the two
    contractions (the tap rows, then the tap columns), as JAX's einsum."""
    return _phase_kernel(_weight_products(w)[0], *w.shape[:2])


def _edge_conv(x: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """k applied to x's first and last pair of lines along `dim` (2 or 3): one
    convolution at stride n - 2, or, for n = 2, the one pair twice.

    Both sides' kernels meet both pairs, and the epilogue reads only each
    side's own half (its backward writes zeros into the other). Giving each
    side only its own pair needs the four lines gathered into a copy per axis,
    whose backward is a zero fill and two slice adds: about eight more
    launches a stage, against an unused half of B 6 Cout (H + W) entries,
    38.5 MB over the decoder's four stages at batch 512 in bf16, about 12 us
    each way at the H100's 3.35 TB/s."""
    n = x.shape[dim]
    stride = (max(n - 2, 1), 1) if dim == 2 else (1, max(n - 2, 1))
    q = F.conv2d(x, k, stride=stride)
    return q if n > 2 else torch.cat([q, q], dim)


class _EdgePad(torch.autograd.Function):
    """The edge-replicating pad by 1 on each side of H and W, whose backward
    adds the border's cotangents onto the edge lines with slices (PyTorch's own
    replication-pad backward adds them with atomics, in an order that changes
    from run to run)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return F.pad(x, (1, 1, 1, 1), mode="replicate")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        gr = g[..., 1:-1, :].clone()
        gr[..., 0, :] += g[..., 0, :]
        gr[..., -1, :] += g[..., -1, :]
        gx = gr[..., 1:-1].clone()
        gx[..., 0] += gr[..., 0]
        gx[..., -1] += gr[..., -1]
        return gx


def _line_op(P: torch.Tensor) -> torch.Tensor:
    """The exact 1-D operator on projected lines: P [B, 3 (tap a), C, n] ->
    [B, C, 2n], sum_a U(P[:, a])[refl(J + a - 1)] with U the 2x bilinear
    upsample (edges clamped) and refl the reflection into [0, 2n)."""
    prev = torch.cat([P[..., :1], P[..., :-1]], -1)
    nxt = torch.cat([P[..., 1:], P[..., -1:]], -1)
    U = torch.stack([0.75 * P + 0.25 * prev, 0.75 * P + 0.25 * nxt], -1).flatten(-2)
    U = torch.cat([U[..., 1:2], U, U[..., -2:-1]], -1)
    n2 = U.shape[-1] - 2
    return U[:, 0, :, 0:n2] + U[:, 1, :, 1:n2 + 1] + U[:, 2, :, 2:n2 + 2]


def upconv_epilogue_reference(y, qr, qc, bias, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch epilogue: y [B, 4 Cout, H, W] (phase channels), qr, qc
    (`fused_upsample_reflect_conv`), bias [Cout] or [L, Cout] (one row per
    B / L consecutive samples) -> [B, Cout, 2H, 2W] in y's dtype.

    f32 inside, with the JAX package's order of additions and its roundings to
    the I/O type: each outer line's correction (rows, then columns, then the
    corner terms) is rounded, added and the sum rounded, then the bias is added
    and the result rounded once more (upconv.py:178-193). Differentiable by
    autograd."""
    B, C4, H, W = y.shape
    C = C4 // 4
    bias = bias.reshape(-1, C).float()
    L = bias.shape[0]

    def r(t):  # rounded to the I/O type
        return t.to(y.dtype).float()

    out = y.float().view(B, 2, 2, C, H, W).permute(0, 3, 4, 1, 5, 2).reshape(B, C, 2 * H, 2 * W)
    q_r = qr.float().view(B, 2, 3, C, 2, W)
    q_c = qc.float().view(B, 2, 3, C, H, 2)
    top, bot = q_r[:, 0, :, :, 0], q_r[:, 1, :, :, 1]  # [B, 3, C, W]
    left, right = q_c[:, 0, ..., 0], q_c[:, 1, ..., 1]  # [B, 3, C, H]
    if H == W:  # the four lines through one operator
        lt, lb, ll, lr = _line_op(torch.stack([top, bot, left, right], 3).flatten(2, 3)).view(
            B, C, 4, 2 * W).unbind(2)
    else:
        lt, lb, ll, lr = (_line_op(t) for t in (top, bot, left, right))
    out = torch.cat([r(out[:, :, :1] + r(lt)[:, :, None]), out[:, :, 1:-1],
                     r(out[:, :, -1:] + r(lb)[:, :, None])], 2)
    out = torch.cat([r(out[..., :1] + r(ll)[..., None]), out[..., 1:-1],
                     r(out[..., -1:] + r(lr)[..., None])], 3)
    # the corner terms D_H D_W, which both sides counted
    c00 = r(0.25 * (top[:, 0, :, 1] - top[:, 0, :, 0]))
    c01 = r(0.25 * (top[:, 2, :, W - 2] - top[:, 2, :, W - 1]))
    c10 = r(0.25 * (bot[:, 0, :, 1] - bot[:, 0, :, 0]))
    c11 = r(0.25 * (bot[:, 2, :, W - 2] - bot[:, 2, :, W - 1]))
    first, last = out[:, :, 0], out[:, :, -1]  # [B, C, 2W]
    first = torch.cat([r(first[..., :1] - c00[..., None]), first[..., 1:-1],
                       r(first[..., -1:] - c01[..., None])], -1)
    last = torch.cat([r(last[..., :1] - c10[..., None]), last[..., 1:-1],
                      r(last[..., -1:] - c11[..., None])], -1)
    out = torch.cat([first[:, :, None], out[:, :, 1:-1], last[:, :, None]], 2)
    out = (out.view(L, B // L, C, 2 * H, 2 * W) + bias.view(L, 1, C, 1, 1)).view(B, C, 2 * H, 2 * W)
    if relu:
        out = torch.relu(out)
    return out.to(y.dtype)


def upconv_epilogue_vjp_reference(g: torch.Tensor, out: torch.Tensor | None = None):
    """(g_y, g_qr, g_qc) of the epilogue for the cotangent g [B, C, 2H, 2W]: the
    adjoint of its linear part (autograd through the plain version at zero
    inputs), applied to g masked by the ReLU where `out` (its output) is given."""
    B, C, H2, W2 = g.shape
    H, W = H2 // 2, W2 // 2
    if out is not None:
        g = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    with torch.enable_grad():
        ins = [torch.zeros(s, dtype=g.dtype, device=g.device, requires_grad=True)
               for s in ((B, 4 * C, H, W), (B, 6 * C, 2, W), (B, 6 * C, H, 2))]
        zero_bias = torch.zeros((1, C), dtype=g.dtype, device=g.device)
        return torch.autograd.grad(upconv_epilogue_reference(*ins, zero_bias), ins, g)


def fused_upsample_reflect_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                                relu: bool = False) -> torch.Tensor:
    """Exact Conv3x3(ReflectPad1(Upsample2x_bilinear(x))) (+ ReLU), NCHW.

    x: [B, Cin, H, W] with H, W >= 2; w: [Cout, Cin, 3, 3]; b: [Cout] or None;
    all of one dtype. Returns [B, Cout, 2H, 2W]. CPU tensors take the plain
    epilogue, CUDA tensors the kernels.
    """
    H, W = x.shape[2:]
    if min(H, W) < 2:
        raise ValueError(f"the fused decoder stage needs H, W >= 2, got {tuple(x.shape)}")
    t, e = _weight_products(w)
    krow, kcol = _edge_kernels(e)
    y = F.conv2d(_EdgePad.apply(x), _phase_kernel(t, *w.shape[:2]))
    qr, qc = _edge_conv(x, krow, 2), _edge_conv(x, kcol, 3)
    if b is None:
        b = x.new_zeros(w.shape[0])
    return upconv_epilogue(y, qr, qc, b, relu)


def _fused_1d(lines: torch.Tensor, w_1d: torch.Tensor, dim: int) -> torch.Tensor:
    """The exact fused upsample + reflect + conv along one spatial dim (2 = H,
    3 = W) of lines [B, Cin, h, w]; w_1d [Cout, Cin, 3] holds the taps along
    `dim`. Returns [B, Cout, ...] with `dim` twice as long (livae_tpu/ops/
    upconv.py:77-121)."""
    n = lines.shape[dim]
    B, O = lines.shape[0], w_1d.shape[0]
    A = _const("A", _A, w_1d.dtype, w_1d.device)
    k = torch.einsum("psa,oia->pois", A, w_1d).reshape(2 * O, -1, 3)  # channel p * O + o
    k = k[:, :, :, None] if dim == 2 else k[:, :, None, :]
    pad = (0, 0, 1, 1) if dim == 2 else (1, 1, 0, 0)
    y = F.conv2d(F.pad(lines, pad, mode="replicate"), k)
    y0, y1 = y.view(B, 2, O, *y.shape[2:]).unbind(1)
    first, second = lines.narrow(dim, 0, 1), lines.narrow(dim, 1, 1)
    penult, ultim = lines.narrow(dim, n - 2, 1), lines.narrow(dim, n - 1, 1)
    d_first = 0.25 * torch.einsum("bchw,oc->bohw", second - first, w_1d[:, :, 0])
    d_last = 0.25 * torch.einsum("bchw,oc->bohw", penult - ultim, w_1d[:, :, 2])
    y0 = torch.cat([y0.narrow(dim, 0, 1) + d_first, y0.narrow(dim, 1, n - 1)], dim)
    y1 = torch.cat([y1.narrow(dim, 0, n - 1), y1.narrow(dim, n - 1, 1) + d_last], dim)
    return torch.stack([y0, y1], dim + 1).flatten(dim, dim + 1)


def fused_upsample_reflect_conv_reference(x: torch.Tensor, w: torch.Tensor,
                                          b: torch.Tensor | None) -> torch.Tensor:
    """The JAX package's assembly (livae_tpu/ops/upconv.py:124-194) in plain
    PyTorch: the phase convolution, `_fused_1d` of the four edge lines and the
    four corner terms, depth-to-space, bias."""
    B, _, H, W = x.shape
    O = w.shape[0]
    y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), phase_kernel(w))
    out = y.view(B, 2, 2, O, H, W).permute(0, 3, 4, 1, 5, 2).reshape(B, O, 2 * H, 2 * W)
    # D_H pushed through the exact W operator, D_W through the exact H operator
    dh_first = _fused_1d(0.25 * (x[:, :, 1:2] - x[:, :, 0:1]), w[:, :, 0], 3)  # [B, O, 1, 2W]
    dh_last = _fused_1d(0.25 * (x[:, :, -2:-1] - x[:, :, -1:]), w[:, :, 2], 3)
    dw_first = _fused_1d(0.25 * (x[..., 1:2] - x[..., 0:1]), w[:, :, :, 0], 2)  # [B, O, 2H, 1]
    dw_last = _fused_1d(0.25 * (x[..., -2:-1] - x[..., -1:]), w[:, :, :, 2], 2)

    def corner(i0, i1, j0, j1, wtap):  # the double count D_H D_W, [B, O]
        d = x[:, :, i1, j1] - x[:, :, i1, j0] - x[:, :, i0, j1] + x[:, :, i0, j0]
        return 0.0625 * (d @ wtap.t())

    out = out.clone()
    out[:, :, :1] += dh_first
    out[:, :, -1:] += dh_last
    out[..., :1] += dw_first
    out[..., -1:] += dw_last
    out[:, :, 0, 0] -= corner(0, 1, 0, 1, w[:, :, 0, 0])
    out[:, :, 0, -1] -= corner(0, 1, W - 1, W - 2, w[:, :, 0, 2])
    out[:, :, -1, 0] -= corner(H - 1, H - 2, 0, 1, w[:, :, 2, 0])
    out[:, :, -1, -1] -= corner(H - 1, H - 2, W - 1, W - 2, w[:, :, 2, 2])
    return out if b is None else out + b.view(1, O, 1, 1)


# ---------------------------------------------------------------------------
# The STN block
# ---------------------------------------------------------------------------


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, 2h, 2w] -> [B, 4C, h, w], channel (p * 2 + q) * C + c."""
    B, C, H, W = x.shape
    y = x.view(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(B, 4 * C, H // 2, W // 2)


def phase_gather_5to3(k5: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 5, 5] -> the phase kernel [4 Cout, 4 Cin, 3, 3]: output
    channel (p, q, o), input channel (pi, qi, i), tap (s, t) holds
    k5[2s + pi - p, 2t + qi - q] (offsets from the centre), or 0."""
    O, I = k5.shape[:2]
    k = k5.reshape(O * I, 25) @ _const("gather", _GATHER, k5.dtype, k5.device)
    k = k.view(O, I, 2, 2, 2, 2, 3, 3).permute(2, 3, 0, 4, 5, 1, 6, 7)
    return k.reshape(4 * O, 4 * I, 3, 3)


def phase_max_reference(y: torch.Tensor, bias: torch.Tensor):
    """Plain PyTorch phase max: y [B, 4 Cout, h, w], bias [Cout] or [L, Cout]
    -> (out [B, Cout, h, w], win [B, Cout, h, w] uint8). out = max over the
    phases of relu(y + b) (the sum in y's dtype), differentiable by autograd
    with the cotangent on the first maximal phase; win is that phase, or 255
    where out <= 0 (relu's gradient 0)."""
    B, C4, h, w = y.shape
    C = C4 // 4
    bias = bias.reshape(-1, C)
    L = bias.shape[0]
    yb = torch.relu((y.view(L, B // L, 4, C, h, w) + bias.view(L, 1, 1, C, 1, 1))
                    .view(B, 4, C, h, w))
    y0, y1, y2, y3 = yb.detach().unbind(1)
    left = torch.maximum(y0, y1) >= torch.maximum(y2, y3)  # ties go to the earlier phase
    first = torch.where(left, torch.where(y0 >= y1, 0, 1), torch.where(y2 >= y3, 2, 3))
    out = yb.gather(1, first[:, None]).squeeze(1)
    win = torch.where(out.detach() > 0, first, 255).to(torch.uint8)
    return out, win


def phase_max_vjp_reference(g: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The cotangent of y: g [B, Cout, h, w] on the winning phase, 0 elsewhere."""
    B, C, h, w = g.shape
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    return torch.stack([torch.where(win == k, g, zero) for k in range(4)], 1).view(B, 4 * C, h, w)


def fused_conv5_relu_maxpool(x: torch.Tensor, k5: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact MaxPool2(ReLU(Conv5x5(x, pad 2, bias b))), NCHW, H and W even.

    x: [B, Cin, H, W]; k5: [Cout, Cin, 5, 5]; b: [Cout]; all of one dtype.
    Returns [B, Cout, H/2, W/2] computed at half resolution. CPU tensors take
    the plain phase max, CUDA tensors the kernels.
    """
    y = F.conv2d(space_to_depth2(x), phase_gather_5to3(k5), padding=1)
    return phase_max(y, b)


# ---------------------------------------------------------------------------
# The kernels (ops/csrc/upconv.cu)
# ---------------------------------------------------------------------------

_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = _build.load("upconv")
    if not _SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.livae_upconv_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.livae_upconv_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.livae_phasemax_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.livae_phasemax_bwd.argtypes = [p, p, p, i, i, i, i, i, p]
        for fn in (lib.livae_upconv_fwd, lib.livae_upconv_bwd, lib.livae_phasemax_fwd,
                   lib.livae_phasemax_bwd):
            fn.restype = i
        _SIGNED = True
    return lib


def _check(what: str, y: torch.Tensor, *others: torch.Tensor) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {y.device}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {y.dtype}")
    for t in others:
        if t.device != y.device or t.dtype != y.dtype:
            raise ValueError(f"{what} kernel: every tensor must be {y.dtype} on {y.device}, "
                             f"got {t.dtype} on {t.device}")


def _lanes(B: int, bias: torch.Tensor, C: int) -> tuple[torch.Tensor, int]:
    """(bias as a contiguous [L, C], samples per bias row)."""
    bias = bias.reshape(-1, C).contiguous()
    if B % bias.shape[0]:
        raise ValueError(f"{bias.shape[0]} bias rows do not divide a batch of {B}")
    return bias, B // bias.shape[0]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_upconv_fwd(y, qr, qc, bias, relu: bool) -> torch.Tensor:
    _check("upconv", y, qr, qc, bias)
    B, C4, H, W = y.shape
    C = C4 // 4
    if C4 != 4 * C or min(H, W) < 2 or qr.shape != (B, 6 * C, 2, W) or qc.shape != (B, 6 * C, H, 2):
        raise ValueError(f"upconv: y {tuple(y.shape)}, qr {tuple(qr.shape)}, qc {tuple(qc.shape)} "
                         f"do not fit [B, 4C, H, W], [B, 6C, 2, W], [B, 6C, H, 2]")
    bias, rows = _lanes(B, bias, C)
    y, qr, qc = y.contiguous(), qr.contiguous(), qc.contiguous()
    out = torch.empty((B, C, 2 * H, 2 * W), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        err = _lib().livae_upconv_fwd(y.data_ptr(), qr.data_ptr(), qc.data_ptr(), bias.data_ptr(),
                                      out.data_ptr(), B, C, H, W, rows, int(relu),
                                      int(y.dtype == torch.bfloat16), _stream(y))
    if err != 0:
        raise RuntimeError(f"upconv forward kernel launch failed: CUDA error {err}")
    _count_launch("UP_FWD_LAUNCHES")
    return out


def _launch_upconv_bwd(g, out):
    """(g_y, g_qr, g_qc) for the cotangent g of the output; `out` (the output)
    masks the ReLU, None where the stage has none."""
    _check("upconv", g, *([] if out is None else [out]))
    B, C, H2, W2 = g.shape
    H, W = H2 // 2, W2 // 2
    g = g.contiguous()
    out = None if out is None else out.contiguous()
    gy = torch.empty((B, 4 * C, H, W), dtype=g.dtype, device=g.device)
    gqr = torch.empty((B, 6 * C, 2, W), dtype=g.dtype, device=g.device)
    gqc = torch.empty((B, 6 * C, H, 2), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = _lib().livae_upconv_bwd(g.data_ptr(), None if out is None else out.data_ptr(),
                                      gy.data_ptr(), gqr.data_ptr(), gqc.data_ptr(), B, C, H, W,
                                      int(g.dtype == torch.bfloat16), _stream(g))
    if err != 0:
        raise RuntimeError(f"upconv backward kernel launch failed: CUDA error {err}")
    _count_launch("UP_BWD_LAUNCHES")
    return gy, gqr, gqc


def _launch_pmax_fwd(y, bias):
    _check("phase max", y, bias)
    B, C4, h, w = y.shape
    C = C4 // 4
    if C4 != 4 * C:
        raise ValueError(f"phase max: y {tuple(y.shape)} has no four phase groups")
    bias, rows = _lanes(B, bias, C)
    y = y.contiguous()
    out = torch.empty((B, C, h, w), dtype=y.dtype, device=y.device)
    win = torch.empty((B, C, h, w), dtype=torch.uint8, device=y.device)
    with torch.cuda.device(y.device):
        err = _lib().livae_phasemax_fwd(y.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                        win.data_ptr(), B, C, h, w, rows,
                                        int(y.dtype == torch.bfloat16), _stream(y))
    if err != 0:
        raise RuntimeError(f"phase max forward kernel launch failed: CUDA error {err}")
    _count_launch("PMAX_FWD_LAUNCHES")
    return out, win


def _launch_pmax_bwd(g, win):
    _check("phase max", g)
    if win.shape != g.shape or win.dtype != torch.uint8 or win.device != g.device:
        raise ValueError("phase max backward: the winner map must be uint8 like the cotangent")
    B, C, h, w = g.shape
    g, win = g.contiguous(), win.contiguous()
    gy = torch.empty((B, 4 * C, h, w), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = _lib().livae_phasemax_bwd(g.data_ptr(), win.data_ptr(), gy.data_ptr(), B, C, h, w,
                                        int(g.dtype == torch.bfloat16), _stream(g))
    if err != 0:
        raise RuntimeError(f"phase max backward kernel launch failed: CUDA error {err}")
    _count_launch("PMAX_BWD_LAUNCHES")
    return gy


def _bias_grad(gy: torch.Tensor, lanes: int) -> torch.Tensor:
    """[lanes, C]: gy [B, 4C, H, W] summed over each bias row's samples, phases
    and pixels, in float32, cast to gy's dtype."""
    B, C4, H, W = gy.shape
    return gy.view(lanes, B // lanes, 4, C4 // 4, H * W).sum((1, 2, 4), dtype=torch.float32
                                                              ).to(gy.dtype)


class UpconvFunction(torch.autograd.Function):
    """The decoder stage's epilogue through the kernels: (y, qr, qc, bias [L, C],
    relu) -> [B, C, 2H, 2W]. The backward kernel gives g_y, g_qr and g_qc (the
    ReLU masked by the saved output); autograd takes them on through cuDNN's
    convolution backward and the phase kernel's build.

    Under `torch.func.vmap` (the stacked trials) the rule folds the lanes into
    the batch, each lane's bias a row of its own, so K lanes make one launch.
    """

    @staticmethod
    def forward(y, qr, qc, bias, relu):
        return _launch_upconv_fwd(y, qr, qc, bias, relu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, _, bias, relu = inputs
        ctx.relu = relu
        ctx.lanes = bias.shape[0]
        ctx.save_for_backward(output if relu else None)

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        gy, gqr, gqc = _launch_upconv_bwd(g, out)
        return gy, gqr, gqc, _bias_grad(gy, ctx.lanes), None

    @staticmethod
    def vmap(info, in_dims, y, qr, qc, bias, relu):
        y, qr, qc, bias = fold_lanes(info.batch_size, in_dims[:4], y, qr, qc, bias)
        return UpconvFunction.apply(y, qr, qc, bias, relu).unflatten(0, (info.batch_size, -1)), 0


def upconv_epilogue(y, qr, qc, bias, relu: bool = False) -> torch.Tensor:
    """The decoder stage's epilogue (see `upconv_epilogue_reference`). CPU
    tensors take the plain version; CUDA tensors launch the kernels or raise."""
    if y.device.type == "cpu":
        return upconv_epilogue_reference(y, qr, qc, bias, relu)
    if y.device.type == "cuda":
        return UpconvFunction.apply(y, qr, qc, bias.reshape(-1, y.shape[1] // 4), relu)
    raise ValueError(f"upconv_epilogue runs on CPU or CUDA tensors, got {y.device}")


class PhaseMaxFunction(torch.autograd.Function):
    """The STN block's phase max through the kernels: (y, bias [L, C]) ->
    (out, win); the winner map is kept for the backward kernel, which routes
    the cotangent first-wins. Under `torch.func.vmap` the lanes fold into the
    batch as in `UpconvFunction`."""

    @staticmethod
    def forward(y, bias):
        return _launch_pmax_fwd(y, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.lanes = inputs[1].shape[0]
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, g, _g_win):
        (win,) = ctx.saved_tensors
        gy = _launch_pmax_bwd(g, win)
        return gy, _bias_grad(gy, ctx.lanes)

    @staticmethod
    def vmap(info, in_dims, y, bias):
        y, bias = fold_lanes(info.batch_size, in_dims, y, bias)
        out, win = PhaseMaxFunction.apply(y, bias)
        K = info.batch_size
        return (out.unflatten(0, (K, -1)), win.unflatten(0, (K, -1))), (0, 0)


def phase_max(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Max over the four phase groups of relu(y + b), first-wins cotangent (see
    `phase_max_reference`). CPU tensors take the plain version; CUDA tensors
    launch the kernels or raise."""
    if y.device.type == "cpu":
        return phase_max_reference(y, bias)[0]
    if y.device.type == "cuda":
        return PhaseMaxFunction.apply(y, bias.reshape(-1, y.shape[1] // 4))[0]
    raise ValueError(f"phase_max runs on CPU or CUDA tensors, got {y.device}")
