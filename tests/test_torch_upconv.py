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


def test_cpu_takes_the_plain_versions_and_the_functions_need_cuda(monkeypatch):
    """CPU tensors run the plain versions: no launch counted, nothing built;
    the kernels' Functions refuse CPU tensors."""
    for name in ("UP_FWD_LAUNCHES", "UP_BWD_LAUNCHES", "PMAX_FWD_LAUNCHES", "PMAX_BWD_LAUNCHES"):
        monkeypatch.setattr(U, name, 0)
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    out = U.fused_upsample_reflect_conv(x, torch.randn(3, 4, 3, 3), torch.randn(3), relu=True)
    out.sum().backward()
    U.fused_conv5_relu_maxpool(x, torch.randn(3, 4, 5, 5), torch.randn(3)).sum().backward()
    assert U.UP_FWD_LAUNCHES == U.UP_BWD_LAUNCHES == U.PMAX_FWD_LAUNCHES == U.PMAX_BWD_LAUNCHES == 0
    assert "upconv" not in _build._LIBS
    with pytest.raises(ValueError, match="CUDA"):
        U.UpconvFunction.apply(torch.zeros(1, 4, 2, 2), torch.zeros(1, 6, 2, 2),
                               torch.zeros(1, 6, 2, 2), torch.zeros(1, 1), False)
    with pytest.raises(ValueError, match="CUDA"):
        U.PhaseMaxFunction.apply(torch.zeros(1, 4, 2, 2), torch.zeros(1, 1))
