"""The port's half-resolution decoder stage and STN block (livae_tpu_torch.ops
.upconv, models.layers) against the JAX package's (livae_tpu.ops.upconv,
models.layers), on the CPU, where the wrappers take the plain versions.

The same inputs, made with numpy from a seed, go through both (NHWC <-> NCHW,
HWIO <-> OIHW). Tolerances: forwards 2e-5 absolute and 1e-5 relative, gradients
3e-5 and 1e-4, those of tests/test_upconv.py (f32 convolutions summed in
another order). The bf16 RVAE against JAX's bf16 model: 1.8307e-4 absolute on
the decoder's output and on mu, logvar and theta, no looser than what the
unfused chain the port ran before showed at patch 128 (batch 8: 1.83076e-4 on
the decoder, 2.2e-3 on mu, 3.8e-3 on logvar). The fused port rounds as JAX does
in the interior; on the outer lines it computes the corrections in f32 from
bf16 projections where JAX rounds through a longer bf16 chain, so about one in
five outer values differs by an ulp, and the differences grow through the
stages: here 1.2e-4 at patch 32 and 1.8305e-4 (one element) at patch 64 on the
decoder, 1.4e-4 at most on the encoder.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.models import layers as jlayers
from livae_tpu.ops import upconv as jup
from livae_tpu_torch import tracing
from livae_tpu_torch.models import layers
from livae_tpu_torch.ops import _build
from livae_tpu_torch.ops import upconv as U

FWD = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=3e-5, rtol=1e-4)
BF16_ATOL = 1.8307e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _oihw(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _inputs(seed, shape, cout, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, k, shape[-1], cout))).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, b


# the JAX tests' shapes (tests/test_upconv.py:30-37: the first stages narrowed,
# odd and rectangular, the minimal n = 2, C_out = 1) and three input channels
UP_SHAPES = [((2, 8, 8, 16), 8), ((2, 16, 16, 8), 4), ((1, 5, 7, 3), 2), ((1, 2, 2, 1), 1),
             ((2, 64, 64, 4), 1), ((2, 8, 8, 3), 5)]
POOL_SHAPES = [((2, 16, 16, 1), 16), ((2, 8, 8, 16), 32), ((1, 4, 12, 3), 4), ((2, 8, 8, 3), 6)]


@pytest.mark.parametrize("impl", ["port", "jax_assembly"])
@pytest.mark.parametrize("shape,cout", UP_SHAPES)
def test_fused_upsample_matches_jax(shape, cout, impl):
    """The port's stage (phase convolution, strided edge convolutions, the plain
    epilogue) and its line-for-line copy of JAX's assembly, each against JAX's."""
    x, w, b = _inputs(sum(shape) + cout, shape, cout, 3)
    want = np.asarray(jup.fused_upsample_reflect_conv(jnp.asarray(x), jnp.asarray(w),
                                                       jnp.asarray(b)))
    fn = (U.fused_upsample_reflect_conv if impl == "port"
          else U.fused_upsample_reflect_conv_reference)
    got = fn(_nchw(x), _oihw(w), torch.from_numpy(b))
    assert got.shape == (shape[0], cout, 2 * shape[1], 2 * shape[2])
    np.testing.assert_allclose(_nhwc(got), want, **FWD)
    if impl == "port":  # the fused ReLU, and no bias
        got = U.fused_upsample_reflect_conv(_nchw(x), _oihw(w), None, relu=True)
        want = np.asarray(jax.nn.relu(jup.fused_upsample_reflect_conv(
            jnp.asarray(x), jnp.asarray(w), None)))
        np.testing.assert_allclose(_nhwc(got), want, **FWD)


@pytest.mark.parametrize("relu", [False, True])
def test_fused_upsample_gradients_match_jax(relu):
    x, w, b = _inputs(0, (2, 6, 6, 3), 2, 3)
    cot = np.random.default_rng(1).standard_normal((2, 12, 12, 2)).astype(np.float32)
    act = jax.nn.relu if relu else (lambda v: v)
    want = jax.grad(lambda *a: jnp.sum(act(jup.fused_upsample_reflect_conv(*a)) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ins = [_nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True),
           torch.from_numpy(b).requires_grad_(True)]
    out = U.fused_upsample_reflect_conv(*ins, relu=relu)
    got = torch.autograd.grad(out, ins, _nchw(cot))
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), **GRAD)
    np.testing.assert_allclose(got[1].numpy().transpose(2, 3, 1, 0), np.asarray(want[1]), **GRAD)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **GRAD)


@pytest.mark.parametrize("shape,cout", POOL_SHAPES)
def test_conv_pool_matches_jax(shape, cout):
    x, k, b = _inputs(sum(shape) + cout, shape, cout, 5)
    want = np.asarray(jup.fused_conv5_relu_maxpool(jnp.asarray(x), jnp.asarray(k),
                                                    jnp.asarray(b)))
    got = U.fused_conv5_relu_maxpool(_nchw(x), _oihw(k), torch.from_numpy(b))
    assert got.shape == (shape[0], cout, shape[1] // 2, shape[2] // 2)
    np.testing.assert_allclose(_nhwc(got), want, **FWD)


def test_conv_pool_gradients_match_jax():
    x, k, b = _inputs(1, (2, 8, 8, 2), 4, 5)
    cot = np.random.default_rng(2).standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jup.fused_conv5_relu_maxpool(*a) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    ins = [_nchw(x).requires_grad_(True), _oihw(k).requires_grad_(True),
           torch.from_numpy(b).requires_grad_(True)]
    got = torch.autograd.grad(U.fused_conv5_relu_maxpool(*ins), ins, _nchw(cot))
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), **GRAD)
    np.testing.assert_allclose(got[1].numpy().transpose(2, 3, 1, 0), np.asarray(want[1]), **GRAD)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **GRAD)


def test_tie_gradient_first_wins():
    """A constant input ties all four phases: the whole cotangent goes to the
    first (even rows and columns), as torch MaxPool2d and tests/test_upconv.py:102."""
    x = torch.ones((1, 1, 8, 8), requires_grad=True)
    k = torch.zeros((1, 1, 5, 5))
    k[0, 0, 2, 2] = 1.0
    out = U.fused_conv5_relu_maxpool(x, k, torch.zeros(1))
    (g,) = torch.autograd.grad(out.sum(), x)
    expect = torch.zeros((8, 8))
    expect[0::2, 0::2] = 1.0
    assert torch.equal(g[0, 0], expect)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_phase_max_routes_as_jax(dtype):
    """Small integers tie phases and hit relu's floor often: the max, the first
    maximal phase and the routed cotangent equal JAX's `_routed_pmax` after
    relu (its zero gradient at 0), bit for bit."""
    rng = np.random.default_rng(3)
    B, C, h, w = 3, 4, 5, 6
    y = rng.integers(-2, 3, (B, 4 * C, h, w)).astype(np.float32)
    bias = np.zeros((C,), np.float32)
    g = rng.standard_normal((B, C, h, w)).astype(np.float32)
    ty, tb = torch.from_numpy(y).to(dtype), torch.from_numpy(bias).to(dtype)
    out, win = U.phase_max_reference(ty, tb)
    yb = jax.nn.relu(jnp.asarray(y.transpose(0, 2, 3, 1)))
    want, d = jup._routed_pmax(yb, jnp.asarray(g.transpose(0, 2, 3, 1)), C)
    d = np.where(np.asarray(yb) > 0, np.asarray(d), 0.0)  # relu's vjp
    np.testing.assert_array_equal(_nhwc(out), np.asarray(want))
    gy = U.phase_max_vjp_reference(torch.from_numpy(g).to(dtype), win)
    np.testing.assert_array_equal(_nhwc(gy), d.astype(np.float32) if dtype == torch.float32
                                  else _nhwc(torch.from_numpy(d.transpose(0, 3, 1, 2)).to(dtype)))
    ins = [ty.clone().requires_grad_(True), tb.clone().requires_grad_(True)]
    ga, _ = torch.autograd.grad(U.phase_max_reference(*ins)[0], ins,
                                torch.from_numpy(g).to(dtype))
    assert torch.equal(ga, gy)
    assert set(win.unique().tolist()) <= {0, 1, 2, 3, 255} and (win == 255).any()


@pytest.mark.parametrize("relu", [False, True])
def test_epilogue_vjp_reference_is_autograd(relu):
    """The U kernel's plain backward: the adjoint of the epilogue's linear part
    at the ReLU mask of its output, equal to autograd through it."""
    rng = np.random.default_rng(4)
    B, C, H, W = 2, 3, 2, 5
    ins = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
           for s in ((B, 4 * C, H, W), (B, 6 * C, 2, W), (B, 6 * C, H, 2), (C,))]
    out = U.upconv_epilogue(*ins, relu)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    want = torch.autograd.grad(out, ins[:3], g)
    got = U.upconv_epilogue_vjp_reference(g, out.detach() if relu else None)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=1e-6)


def test_phase_kernel_rounds_as_jax():
    """In bf16 the phase kernel equals JAX's einsum bit for bit: the weight is
    rounded first, then each of the two contractions."""
    w = (0.3 * np.random.default_rng(5).standard_normal((3, 3, 16, 8))).astype(np.float32)
    A = jnp.asarray(np.stack([jup._A0, jup._A1]), jnp.bfloat16)
    want = jnp.einsum("psa,qtb,abio->pqstio", A, A, jnp.asarray(w).astype(jnp.bfloat16))
    want = np.asarray(jnp.transpose(want, (0, 1, 5, 4, 2, 3)).astype(jnp.float32))
    got = U.phase_kernel(_oihw(w).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want.reshape(32, 16, 3, 3))


@functools.lru_cache(maxsize=None)
def _jax_layer(kind: str, cin: int, cout: int, dtype):
    cls = jlayers.FusedUpConv if kind == "up" else jlayers.FusedConvPool
    module = cls(cout, dtype=dtype)
    params = module.init(jax.random.key(0), jnp.zeros((1, 8, 8, cin)))
    return module, params


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["up", "pool"])
def test_layers_match_jax(kind, dtype):
    """FusedUpConv and FusedConvPool with JAX's initialised weights carried
    across (OIHW): f32 within FWD, bf16 within one bf16 ulp at the output's
    largest value (the convolutions round their sums in another order)."""
    cin, cout = 3, 5
    module, params = _jax_layer(kind, cin, cout, dtype)
    x = np.random.default_rng(6).standard_normal((2, 8, 8, cin)).astype(np.float32)
    want = np.asarray(module.apply(params, jnp.asarray(x)).astype(jnp.float32))
    if kind == "up":
        layer = layers.FusedUpConv(cin, cout, compute_dtype=dtype)
    else:
        layer = layers.FusedConvPool(cin, cout, compute_dtype=dtype)
    p = params["params"]["conv"]
    with torch.no_grad():
        layer.weight.copy_(_oihw(p["kernel"]))
        layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        got = layer(_nchw(x))
    assert set(layer.state_dict()) == {"weight", "bias"}
    if dtype is None:
        np.testing.assert_allclose(_nhwc(got), want, **FWD)
    else:
        assert got.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(max(1.0, np.abs(want).max()))) - 7)
        np.testing.assert_allclose(_nhwc(got), want, atol=ulp)


def test_pool_and_pad_match_jax():
    x = np.random.default_rng(7).standard_normal((2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(layers.max_pool_2x2(_nchw(x))),
                                  np.asarray(jlayers.max_pool_2x2(jnp.asarray(x))))
    np.testing.assert_array_equal(_nhwc(layers.reflection_pad_1(_nchw(x))),
                                  np.asarray(jlayers.reflection_pad_1(jnp.asarray(x))))


@functools.lru_cache(maxsize=None)
def _bf16_pair(patch, latent):
    import livae_tpu.models.rvae as jrvae
    from livae_tpu.models import init_params
    from livae_tpu_torch.models.rvae import RVAE
    from livae_tpu_torch.utils.checkpoint import load_jax_params

    jmodel = jrvae.RVAE(latent_dim=latent, in_channels=1, patch_size=patch,
                        compute_dtype="bfloat16")
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, patch, patch, 1)))
    tmodel = RVAE(latent, 1, patch, "bfloat16", device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("patch,latent", [(32, 8), (64, 16)])
def test_bf16_decode_and_encode_match_jax(patch, latent):
    """The production dtype: the port's bf16 RVAE against JAX's with the same
    weights (load_jax_params), decoder output and encoder outputs."""
    jmodel, params, tmodel = _bf16_pair(patch, latent)
    rng = np.random.default_rng(8)
    z = rng.standard_normal((4, latent)).astype(np.float32)
    x = rng.random((4, patch, patch, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply(p, a, method="decode"))(
        params, jnp.asarray(z)))
    want_enc = jax.jit(lambda p, a: jmodel.apply(p, a, method="encode"))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))
        got_enc = tmodel.encode(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=BF16_ATOL, rtol=0)
    for name, g, w in zip(("mu", "logvar", "theta"), got_enc, want_enc):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w), atol=BF16_ATOL, rtol=0,
                                   err_msg=name)


def test_cpu_takes_the_plain_versions_and_the_functions_need_cuda():
    """CPU tensors run the plain versions: no launch counted, nothing built;
    the kernels' Functions refuse CPU tensors."""
    before = tracing.counters()
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    out = U.fused_upsample_reflect_conv(x, torch.randn(3, 4, 3, 3), torch.randn(3), relu=True)
    out.sum().backward()
    U.fused_conv5_relu_maxpool(x, torch.randn(3, 4, 5, 5), torch.randn(3)).sum().backward()
    assert tracing.counters() == before
    assert "upconv" not in _build._LIBS
    with pytest.raises(ValueError, match="CUDA"):
        U.UpconvFunction.apply(torch.zeros(1, 4, 2, 2), torch.zeros(1, 6, 2, 2),
                               torch.zeros(1, 6, 2, 2), torch.zeros(1, 1), False)
    with pytest.raises(ValueError, match="CUDA"):
        U.PhaseMaxFunction.apply(torch.zeros(1, 4, 2, 2), torch.zeros(1, 1))


# The launch plans' shapes: the main path's four decoder stages (B, C_out, H, W)
# at batch 512 (the epilogue and its adjoint) and two STN blocks (B, C_out, h,
# w) on the [1024] pair, and the edge shapes chip_smoke.py holds on the card
# (widths that are no whole number of 16-byte runs, runs that are a whole
# output row, one-pixel maps)
_STAGES = ((512, 128, 8, 8), (512, 64, 16, 16), (512, 32, 32, 32), (512, 1, 64, 64))
_STAGES_EDGE = ((3, 4, 2, 2), (3, 1, 5, 7), (2, 3, 2, 9), (2, 2, 3, 4), (2, 2, 4, 12))
PLAN_MAIN = [("upconv_fwd", s) for s in _STAGES] + \
            [("phasemax_bwd", s) for s in ((1024, 16, 64, 64), (1024, 32, 32, 32))] + \
            [("upconv_bwd", s) for s in _STAGES]
PLAN_EDGE = [("upconv_fwd", s) for s in _STAGES_EDGE] + \
            [("phasemax_bwd", s)
             for s in ((3, 1, 2, 2), (3, 4, 2, 6), (2, 3, 1, 1), (2, 3, 4, 8))] + \
            [("upconv_bwd", s) for s in _STAGES_EDGE]
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


# the bytes of a thread's run the plan picks at the main path's shapes (bf16,
# f32): the longest run that the width takes and that leaves MIN_BLOCKS blocks
MAIN_RUN_BYTES = {(512, 128, 8, 8): (32, 64), (512, 64, 16, 16): (64, 64),
                  (512, 32, 32, 32): (64, 64), (512, 1, 64, 64): (32, 64),
                  (1024, 16, 64, 64): (16, 16), (1024, 32, 32, 32): (16, 16)}
# the same for upconv_bwd's runs of g (each stage has at least MIN_BLOCKS
# blocks' worth of runs of 32 bytes, the last one exactly as many in bf16)
MAIN_BWD_RUN_BYTES = {(512, 128, 8, 8): (32, 32), (512, 64, 16, 16): (32, 32),
                      (512, 32, 32, 32): (32, 32), (512, 1, 64, 64): (32, 32)}


def _offset_align(kernel, dtype):
    """Every pointer of a view one element into its storage (chip_smoke.py's
    offset views; the wrapper's output stays a fresh allocation)."""
    e = _ELEM[dtype]
    return {"upconv_fwd": (e, 16), "upconv_bwd": (e, e, 16)}.get(kernel, (e, 1, 16))


def _want_elems(kernel, shape, dtype, offset):
    """The run the plan should pick: one element wherever the pointers are
    misaligned; MAIN_RUN_BYTES at the main path's shapes; at the small edge
    shapes (under MIN_BLOCKS blocks) the shortest vector run, 16 bytes, where
    the row (2W) or plane (h w) holds a whole number of them; else one."""
    if offset:
        return 1
    main = MAIN_BWD_RUN_BYTES if kernel == "upconv_bwd" else MAIN_RUN_BYTES
    if shape in main:
        return main[shape][dtype == torch.float32] // _ELEM[dtype]
    width = shape[2] * shape[3] if kernel == "phasemax_bwd" else 2 * shape[3]
    n = 16 // _ELEM[dtype]
    return n if width % n == 0 else 1


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,shape", PLAN_MAIN + PLAN_EDGE,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_launch_plan_picks_the_variant(kernel, shape, dtype, offset):
    """The main path's shapes take the vector variant (runs of RUN_BYTES) on
    aligned tensors; a ragged width takes shorter runs or the scalar variant,
    and a view one element into its storage the scalar variant; threads and
    blocks cover the work. upconv_bwd's blocks own whole planes, as many as
    give the block's threads about one run each, with their outer lines'
    shared memory; on the main path at least MIN_BLOCKS blocks' worth of runs,
    and MIN_BLOCKS blocks where there are as many planes."""
    align = _offset_align(kernel, dtype) if offset else None
    plan = U.launch_plan(kernel, shape, dtype, align)
    n = _want_elems(kernel, shape, dtype, offset)
    assert (plan.variant, plan.elems_per_thread) == ("vector" if n > 1 else "scalar", n)
    B, C, H, W = shape
    if kernel == "upconv_bwd":
        P = plan.planes_per_block
        if (kernel, shape) in PLAN_MAIN and not offset:
            assert plan.variant == "vector" and plan.blocks >= min(U.MIN_BLOCKS, B * C)
            assert U._threads(kernel, shape, dtype, n) >= U.MIN_BLOCKS * U.THREADS
        assert plan.threads == U.THREADS and plan.blocks == -(-B * C // P)
        assert plan.smem == P * 16 * (H + W) <= U.SMEM_MAX
        assert P == min(max(1, U.THREADS // (4 * H * W // n)), B * C)
        return
    if (kernel, shape) in PLAN_MAIN and not offset:
        assert plan.variant == "vector" and plan.blocks >= U.MIN_BLOCKS
    assert plan.threads == U.THREADS and plan.smem == 0 and plan.planes_per_block == 0
    n_threads = U._threads(kernel, shape, dtype, n)
    assert (plan.blocks - 1) * plan.threads < n_threads <= plan.blocks * plan.threads


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,shape", PLAN_MAIN + PLAN_EDGE,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_launch_plan_writes_every_output_once(kernel, shape, dtype, offset):
    """Enumerated from the plan's own fields as the kernel maps its threads,
    the runs write every element of out (upconv_fwd) or g_y (phasemax_bwd)
    exactly once, each thread a run of elems_per_thread consecutive elements
    (of at most 16 bytes in upconv_fwd's rows 0 and 2H-1); upconv_bwd's
    every element of g_y, g_qr and g_qc, zeros included. The main path's
    batch is cut to 2: a thread's place depends on B only through the count of
    planes."""
    shape = (min(shape[0], 2),) + shape[1:]
    align = _offset_align(kernel, dtype) if offset else None
    plan = U.launch_plan(kernel, shape, dtype, align)
    runs = plan.writes()
    B, C, H, W = shape
    if kernel == "upconv_bwd":
        _check_bwd_writes(plan, runs)
        return
    written = np.concatenate([r.ravel() for r in runs])
    assert written.min() == 0 and np.array_equal(np.bincount(written), np.ones(4 * B * C * H * W))
    assert sum(len(r) for r in runs) == U._threads(kernel, shape, dtype, plan.elems_per_thread)
    n = plan.elems_per_thread
    for r in runs:
        step = 1 if kernel == "upconv_fwd" else H * W  # a phase's elements lie h w apart
        k = min(n, 16 // _ELEM[dtype]) if kernel == "upconv_fwd" and r is runs[0] else n
        assert r.shape[1] == (k if kernel == "upconv_fwd" else 4 * n)
        run = r[:, :k]
        assert (np.diff(run, axis=1) == 1).all() and (run[:, 0] % k == 0).all()
        if kernel == "phasemax_bwd":
            assert (r[:, k:2 * k] - run == step * C).all()


def _check_bwd_writes(plan, runs):
    """upconv_bwd's writes: g_y, g_qr and g_qc each element once; a run of g
    of n elements writes its n / 2 even columns consecutively into one phase
    plane and its odd ones C H W further (the (p, 1) plane), each half at a
    multiple of its own length (the stores' alignment); an outer line's item
    one entry beside the other line's zero (g_qr: W apart; g_qc: an aligned
    pair)."""
    B, C, H, W = plan.shape
    n = plan.elems_per_thread
    gy, gqr, gqc = runs
    for got, size in ((gy, 4 * B * C * H * W), (gqr, 12 * B * C * W), (gqc, 12 * B * C * H)):
        assert np.array_equal(np.bincount(got.ravel(), minlength=size), np.ones(size))
    assert gy.shape == (U._threads("upconv_bwd", plan.shape, plan.dtype, n), n)
    if n > 1:
        even, odd = gy[:, :n // 2], gy[:, n // 2:]
        assert (np.diff(even, axis=1) == 1).all() and (odd - even == C * H * W).all()
        assert (even[:, 0] % (n // 2) == 0).all()
    assert gqr.shape[1] == gqc.shape[1] == 2
    assert (np.abs(gqr[:, 1] - gqr[:, 0]) == W).all()
    assert (gqc[:, 0] % 2 == 0).all() and (gqc[:, 1] - gqc[:, 0] == 1).all()


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    """Elements a thread that the shape or the pointers do not take, another
    kernel, dtype or shape: ValueError or TypeError, never a quiet fallback."""
    bf = torch.bfloat16
    assert U.launch_plan("upconv_fwd", (2, 4, 8, 8), bf, elems=8).elems_per_thread == 8
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("upconv_fwd", (2, 4, 8, 9), bf, elems=8)  # 2W = 18
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("upconv_fwd", (2, 4, 8, 8), bf, (8, 16), elems=16)  # y needs 16 bytes
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("upconv_fwd", (2, 4, 8, 8), bf, elems=32)  # 2W = 16: no run of 32
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("phasemax_bwd", (2, 4, 8, 8), bf, (16, 4, 16), elems=8)  # win: 8 bytes
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("phasemax_bwd", (2, 4, 8, 8), bf, elems=16)  # the routing's runs: 16 B
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("phasemax_bwd", (2, 4, 8, 8), bf, elems=3)
    assert U.launch_plan("upconv_fwd", (2, 4, 8, 8), bf, (8, 16)).elems_per_thread == 8
    with pytest.raises(ValueError, match="plans"):
        U.launch_plan("phasemax_fwd", (2, 4, 8, 8), bf)
    with pytest.raises(TypeError):
        U.launch_plan("upconv_fwd", (2, 4, 8, 8), torch.float16)
    with pytest.raises(ValueError, match="H, W >= 2"):
        U.launch_plan("upconv_fwd", (2, 4, 1, 8), bf)
    with pytest.raises(ValueError, match="alignment"):
        U.launch_plan("phasemax_bwd", (2, 4, 8, 8), bf, (16, 16))


def test_upconv_bwd_plan_refuses_what_the_kernel_does_not_take():
    """The adjoint's plan: a run the width does not take, a g, out or g_y
    misaligned to its accesses, a plane whose outer lines need more than
    SMEM_MAX bytes of shared memory: ValueError, never a quiet fallback; what
    it takes, it plans."""
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("upconv_bwd", (2, 4, 8, 9), bf, elems=8)  # 2W = 18
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("upconv_bwd", (2, 4, 8, 8), bf, elems=32)  # 2W = 16: no run of 32
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("upconv_bwd", (2, 4, 32, 32), bf, elems=32)  # runs of 64 bytes: none
    for align in ((8, 16, 16), (16, 8, 16), (2, 16, 16), (16, 16, 4)):  # g, out, g_y
        with pytest.raises(ValueError, match="does not take"):
            U.launch_plan("upconv_bwd", (2, 4, 8, 8), bf, align, elems=8)
    with pytest.raises(ValueError, match="does not take"):
        U.launch_plan("upconv_bwd", (2, 4, 8, 8), bf, (16, 16, 8), elems=16)  # g_y: 16 bytes
    assert U.launch_plan("upconv_bwd", (2, 4, 8, 8), bf, (16, 16, 8), elems=8).variant == "vector"
    assert U.launch_plan("upconv_bwd", (2, 4, 8, 8), bf, (16, 8, 16)).variant == "scalar"
    with pytest.raises(ValueError, match="shared memory"):
        U.launch_plan("upconv_bwd", (1, 1, 8000, 8000), bf)  # one plane's lines: 256,000 bytes
    assert U.launch_plan("upconv_bwd", (1, 1, 7000, 7000), bf).smem == 16 * 14000
    with pytest.raises(ValueError, match="H, W >= 2"):
        U.launch_plan("upconv_bwd", (2, 4, 8, 1), bf)
    with pytest.raises(ValueError, match="alignment"):
        U.launch_plan("upconv_bwd", (2, 4, 8, 8), bf, (16, 16))


def test_alignment_reads_the_pointer():
    """A tensor's alignment is the largest power of two up to 16 dividing its
    data pointer: a fresh allocation 16, a view k elements in less."""
    base = torch.empty(64, dtype=torch.bfloat16)
    assert U.alignment(base) == 16
    assert [U.alignment(base[k:]) for k in (1, 2, 4, 8, 16)] == [2, 4, 8, 16, 16]
