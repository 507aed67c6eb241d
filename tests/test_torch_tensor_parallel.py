"""Tensor parallelism of the port (livae_tpu_torch.parallel: `make_mesh2d`,
`dense_param_specs`, `place_with_specs`, the row- and column-parallel layers)
on gloo ranks on the CPU, at f32 (patch 32, latent 8, global batch 16).

The ranks are spawned processes meeting through a file store under tmp_path,
as in tests/test_torch_parallel.py, whose JAX run, sites and bounds this
module shares: 1x2 and 2x2 (data x model) meshes train from JAX's weights
with JAX's draws and noise injected, and are held to the port in one process
at 1e-5 (with the rule for Adam's flips of
`_assert_equal_within_but_where_jax_differs`) and to livae_tpu's
single-device step within tests/test_torch_engine.py's bounds.
The JAX package's own proof holds its 4x2 step to one device at loss rtol
1e-5 and params atol 2e-5 (tests/test_parallel.py).

This module is imported by the spawned ranks: JAX is imported inside the
tests only.
"""

import numpy as np
import pytest
import torch
from test_torch_parallel import (  # noqa: F401  (sites is a fixture)
    B,
    BETA,
    GAMMA,
    LATENT,
    MARGIN,
    PAD,
    PATCH,
    STEPS,
    _assert_like_jax,
    _jax_run,
    sites,
)

from livae_tpu_torch.data.pipeline import AugmentConfig
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.parallel import mesh as pm
from livae_tpu_torch.parallel import tensor as pt
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train.state import make_optimizer
from livae_tpu_torch.utils import checkpoint as tc

MESHES = {"1x2": (2, 2), "2x2": (4, 2)}  # name -> (ranks, model ways)
# patch 128's split layers (the production widths): 1,835,008 weights and a bias
PATCH128_SPECS = {"encoder.rotation_stn.localization.7.weight": 1,
                  "encoder.fc_mu.weight": 1, "encoder.fc_logvar.weight": 1,
                  "decoder.fc.weight": 0, "decoder.fc.bias": 0}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread here and in every rank (spawn passes it on)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(kind, state=None, mesh=None):
    """The port's model of `kind`, loaded from `state`, split over `mesh`'s
    model axis where it has one."""
    model = (RVAE if kind == "rvae" else VAE)(LATENT, 1, PATCH, device="cpu",
                                             generator=torch.Generator().manual_seed(3))
    if state is not None:
        model.load_state_dict(state)
    if mesh is not None and mesh.model_size > 1:
        pm.place_with_specs(model, mesh, pm.dense_param_specs(model, mesh.model_size))
    return model


def _layers(model) -> dict:
    """{name: (class name, weight shape)} of every dense layer."""
    return {n: (type(m).__name__, tuple(m.weight.shape)) for n, m in model.named_modules()
            if isinstance(m, (torch.nn.Linear, pt.RowParallelLinear, pt.ColumnParallelLinear))}


def _tp_steps(mesh, device, kind, state, table, idx, draws, eps, use_diversity):
    """STEPS fused train steps of a model loaded from `state` and placed on
    `mesh` (None: this process alone), the optimizer built after the
    placement. Returns the step means, the one-device weights after, and the
    dense layers as this rank holds them."""
    model = _model(kind, state, mesh)
    kw = dict(patch_size=PATCH, padding=PAD, margin=MARGIN, use_diversity=use_diversity,
              device="cpu", mesh=mesh)
    if kind == "rvae":
        opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
        step = te.make_fused_rvae_train_step(model, opt, cfg=AugmentConfig(),
                                             canonical_weight=0.2, grad_max_norm=20.0, **kw)
    else:
        opt = make_optimizer(model.parameters(), 1e-3, optimizer="adam")
        step = te.make_fused_vae_train_step(model, opt, cfg=AugmentConfig(), grad_max_norm=5.0,
                                            **kw)
    m = step(*table, idx, None, BETA, GAMMA, draws=draws, eps=eps)
    return {"metrics": te.metrics_to_host(m),
            "state": {k: v.detach().clone() for k, v in pt.full_state_dict(model, mesh).items()},
            "layers": _layers(model)}


def _assert_equal_within_but_where_jax_differs(a, b, jstate, tol):
    """`_assert_equal_within`'s rule, less the elements where JAX's step and
    the port's step in one process already differ beyond `tol`.

    Where an element's gradient is in the noise, Adam's first steps move it
    by about lr one way or the other, and any change in the order of float32
    sums can decide which. The STN's first dense layer ([2048, 32]) sums 2048
    products, split in two here; with the rVAE's no-diversity data below,
    that alone (like JAX's own order, or the one-process port's nn.Linear
    swapped for matmul + bias) sends 0.113 % of the elements the other way
    after two steps, the same elements by which JAX and the one-process port
    differ (0.114 %), while the split run and JAX differ in 0.0007 %. So
    those elements are left out; the rest must meet the rule (step means
    within `tol`, every weight within 2 lr per step, fewer than 0.1 %
    beyond `tol`)."""
    for k in a["metrics"]:
        np.testing.assert_allclose(a["metrics"][k], b["metrics"][k], atol=tol, rtol=tol,
                                   err_msg=k)
    d, d_jax = (np.concatenate([np.abs(v.numpy() - ref[k].numpy()).ravel()
                                for k, v in b["state"].items()])
                for ref in (a["state"], jstate))
    assert d.max() <= 2 * 1e-3 * STEPS
    assert np.mean((d > tol) & (d_jax <= tol)) < 1e-3


_JAX = {}


def _jax_once(kind, sites, use_diversity, rng, monkeypatch):
    """`_jax_run`, once per (kind, diversity) in this module: both meshes
    start from the same JAX weights, draws and noise."""
    key = (kind, use_diversity)
    if key not in _JAX:
        _JAX[key] = _jax_run(kind, sites, use_diversity, rng, monkeypatch)
    return _JAX[key]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind,use_diversity", [("rvae", False), ("rvae", True),
                                                ("vae", False)],
                         ids=["rvae", "rvae_diversity", "vae"])
def test_tensor_parallel_step_as_one_device(tmp_path, sites, rng, monkeypatch, kind,
                                            use_diversity, mesh_name):
    """Two fused train steps with the large dense layers split over 2 model
    ways, against the port in one process (within 1e-5) and livae_tpu's
    single-device step; the split layers stay split through the steps."""
    want, jstate, start, draws, eps = _jax_once(kind, sites, use_diversity, rng, monkeypatch)
    args = (kind, start, sites[4], torch.from_numpy(sites[3]).long(), draws, eps,
            use_diversity)
    n, n_model = MESHES[mesh_name]
    split = pm.spawn(_tp_steps, n, *args, device_type="cpu", root=tmp_path,
                     model_parallel=n_model)
    one = _tp_steps(None, torch.device("cpu"), *args)
    _assert_equal_within_but_where_jax_differs(split, one, jstate, 1e-5)
    _assert_like_jax(split, want, jstate)
    assert split["state"].keys() == one["state"].keys()
    assert all(v.shape == one["state"][k].shape for k, v in split["state"].items())
    # the counterpart of JAX's "stayed model-sharded" assertion
    for name, (cls, shape) in split["layers"].items():
        full = one["layers"][name][1]
        if name in ("encoder.fc_mu", "encoder.fc_logvar", "encoder.rotation_stn.localization.7"):
            assert (cls, shape) == ("RowParallelLinear", (full[0], full[1] // 2)), name
        elif name == "decoder.fc":
            assert (cls, shape) == ("ColumnParallelLinear", (full[0] // 2, full[1])), name
        else:
            assert (cls, shape) == ("Linear", full), name
    assert not list(tmp_path.iterdir())  # the rendezvous directory is removed


def _evals(mesh, device, states, table, idx, draws, eps):
    """One fused eval batch of the rVAE (paired) and of the VAE."""
    out = {}
    for kind, state in states.items():
        model = _model(kind, state, mesh)
        kw = dict(patch_size=PATCH, padding=PAD, margin=MARGIN, device="cpu", mesh=mesh)
        if kind == "rvae":
            ev = te.make_fused_rvae_eval(model, cfg=AugmentConfig(), canonical_weight=0.2, **kw)
            m = ev(*table, idx, None, BETA, GAMMA, draws=draws, eps=eps)
        else:
            ev = te.make_fused_eval(model, **kw)
            m = ev(*table, idx, None, BETA, 0.0, eps=eps)
        out[kind] = te.metrics_to_host(m)
    return out


def test_tensor_parallel_eval_as_one_device(tmp_path, sites):
    """One fused eval batch of each model on a 2x2 mesh, against one process
    at 1e-5."""
    g = torch.Generator().manual_seed(4)
    states = {k: _model(k).state_dict() for k in ("rvae", "vae")}
    args = (states, sites[4], torch.from_numpy(sites[3][:1]).long(),
            [te.sample_paired_draws(B, AugmentConfig(), g, "cpu")],
            [torch.randn((B, LATENT), generator=g)])
    split = pm.spawn(_evals, 4, *args, device_type="cpu", root=tmp_path, model_parallel=2)
    one = _evals(None, torch.device("cpu"), *args)
    for kind in states:
        assert split[kind].keys() == one[kind].keys()
        for k, v in one[kind].items():
            np.testing.assert_allclose(split[kind][k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{kind} {k}")


def _round_trip(mesh, device, state):
    """Place an rVAE, gather its state and an Adam state after one step, and
    load both into a fresh placed model and optimizer."""
    model = _model("rvae", state, mesh)
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    placed = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    full = {k: v.clone() for k, v in pt.full_state_dict(model, mesh).items()}
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5) * (mesh.model_rank + 1)
    opt.step()
    moments = pt.full_optimizer_state(opt, mesh)
    fresh = _model("rvae", None, mesh)
    fresh_opt = make_optimizer(fresh.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    pt.load_full_state_dict(fresh, full, mesh)
    pt.load_full_optimizer_state(fresh_opt, moments, mesh)
    return {"placed": placed, "full": full, "again": pt.full_state_dict(fresh, mesh),
            "moments": moments, "moments_again": pt.full_optimizer_state(fresh_opt, mesh),
            "slices": {k: v.clone() for k, v in fresh.state_dict().items()},
            "model_rank": mesh.model_rank}


def test_full_state_round_trips_exactly(tmp_path):
    """`full_state_dict` of a placed model is the one-device state dict,
    bit for bit; loading it (and the gathered Adam moments) into a fresh
    placed model slices it back to the same parts."""
    state = RVAE(LATENT, 1, PATCH, device="cpu",
                 generator=torch.Generator().manual_seed(8)).state_dict()
    out = pm.spawn(_round_trip, 2, state, device_type="cpu", root=tmp_path, model_parallel=2)
    assert out["model_rank"] == 0
    assert out["full"].keys() == state.keys() == out["again"].keys()
    for k, v in state.items():
        assert torch.equal(out["full"][k], v) and torch.equal(out["again"][k], v), k
    assert out["placed"]["encoder.fc_mu.weight"] == (LATENT, 512)
    assert out["placed"]["decoder.fc.weight"] == (512, LATENT)
    assert out["placed"]["decoder.fc.bias"] == (512,)
    assert torch.equal(out["slices"]["decoder.fc.weight"], state["decoder.fc.weight"][:512])
    # Adam's moments come back whole: rank 1's half of a split weight saw grads of 1.0
    m = out["moments"]["state"]
    names = [n for n, _ in RVAE(LATENT, 1, PATCH, device="cpu").named_parameters()]
    mu = m[names.index("encoder.fc_mu.weight")]["exp_avg"]
    assert mu.shape == state["encoder.fc_mu.weight"].shape
    np.testing.assert_allclose(mu[:, :512].numpy(), 0.05, rtol=1e-6)
    np.testing.assert_allclose(mu[:, 512:].numpy(), 0.1, rtol=1e-6)
    for i, s in m.items():
        for k, v in s.items():
            assert torch.equal(out["moments_again"]["state"][i][k], v), (i, k)


def test_dense_param_specs_match_jax():
    """The port's split layers are JAX's, mapped through the checkpoint
    bridge's specs: at patch 32 the encoder heads (and the STN's first dense
    layer, [2048, 32]) are row-parallel and the decoder fc column-parallel
    with its bias; at patch 128 the four weights of the production model."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import livae_tpu.models.rvae as jrvae
    import livae_tpu.models.vae as jvae
    from livae_tpu.parallel.mesh import dense_param_specs as jax_specs

    def mapped(specs, spec_list):
        out = {}
        for path, prefix, kind, _ in spec_list:
            node = specs["params"]
            for p in path:
                node = node[p]
            if node["kernel"] == P("model", None):
                out[f"{prefix}.weight"] = 1
            elif node["kernel"] == P(None, "model"):
                out[f"{prefix}.weight"] = 0
            if node.get("bias") == P("model"):
                out[f"{prefix}.bias"] = 0
        return out

    for patch in (32, 128):
        for jcls, tcls, spec in ((jrvae.RVAE, RVAE, tc.rvae_spec), (jvae.VAE, VAE, tc.vae_spec)):
            jmodel = jcls(latent_dim=LATENT, patch_size=patch)
            shapes = jax.eval_shape(
                jmodel.init, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                jnp.zeros((1, patch, patch, 1)))
            want = mapped(jax_specs(shapes, n_model=2), spec(patch, LATENT))
            got = pm.dense_param_specs(tcls(LATENT, 1, patch, device="cpu"), 2)
            assert got == want, (patch, jcls.__name__)
            assert "encoder.fc_mu.weight" in got and got.get("decoder.fc.bias") == 0
            assert not any("conv" in k or "localization.9" in k for k in got)
    big = RVAE(16, 1, 128, device="cpu")
    specs = pm.dense_param_specs(big, 2)
    assert specs == PATCH128_SPECS
    params = dict(big.named_parameters())
    assert sum(params[k].numel() for k in specs if k.endswith("weight")) == 1_835_008


@pytest.mark.parametrize("flags,match", [
    (("8", 3, 16), "--num-devices 8 must be divisible by --model-parallel 3"),
    (("8", 2, 63), r"--batch-size 63 must be divisible by the data-parallel ways \(4 ="),
    (("1", 2, 16), "--num-devices 1 must be divisible by --model-parallel 2"),
])
def test_setup_mesh_2d_exits(monkeypatch, flags, match):
    monkeypatch.setattr(pm, "local_device_count", lambda device_type: 8)
    with pytest.raises(SystemExit, match=match):
        pm.setup_mesh_from_flags(*flags, "cpu")


def test_setup_mesh_2d_prints_the_jax_line(monkeypatch, capsys):
    monkeypatch.setattr(pm, "local_device_count", lambda device_type: 8)
    model = RVAE(LATENT, 1, PATCH, device="cpu")
    assert pm.setup_mesh_from_flags("4", 2, 16, "cpu", model) == (2, 2)
    assert capsys.readouterr().out == (
        "2-D mesh: 2 data x 2 model {'data': 2, 'model': 2}; 5 model-sharded dense params\n")
    small = RVAE(LATENT, 1, 16, device="cpu")  # nothing reaches 1024 features
    assert pm.setup_mesh_from_flags("2", 2, 16, "cpu", small) == (1, 2)
    out = capsys.readouterr().out
    assert "1 data x 2 model" in out and "0 model-sharded" in out and "note:" in out


def test_tp_boundary_without_a_model_axis_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert pt.tp_boundary(x) is x
    assert pt.tp_boundary(x, pm.DataMesh(0, 2)) is x
    assert pm.DataMesh(1, 2, 1, 2).world_rank == 3


def test_the_placed_model_needs_its_optimizer_built_after():
    """`place_with_specs` swaps in new parameters: an optimizer built before
    holds the replaced ones, which the model no longer uses."""
    model = _model("rvae")
    before = list(model.parameters())
    mesh = pm.DataMesh(0, 1, 0, 2)
    pm.place_with_specs(model, mesh, pm.dense_param_specs(model, 2))
    after = list(model.parameters())
    assert len(after) == len(before)
    # the four split layers' weights and biases are new parameters
    assert sum(all(p is not q for q in after) for p in before) == 8
    assert isinstance(model.encoder.rotation_stn.localization[7], pt.RowParallelLinear)
    assert isinstance(model.decoder.fc, pt.ColumnParallelLinear)
    assert model.state_dict().keys() == _model("rvae").state_dict().keys()


def test_resume_of_a_split_run_is_bit_equal(tmp_path, monkeypatch):
    """`train_rvae --num-devices 2 --model-parallel 2`: one epoch, an
    interruption, then `--resume` (the resume file's one-device weights and
    Adam moments sliced again over the model ways), against two straight
    epochs: the same digests of the gathered state, and the same weights."""
    from livae_tpu_torch.scripts import train_rvae
    from livae_tpu_torch.utils.resume import restore_train_state

    monkeypatch.setenv("LIVAE_PARAM_HASH", "1")
    small = ["--cpu", "--no-amp", "--synthetic", "1", "--synthetic-size", "512",
             "--patch-size", "32", "--padding", "8", "--batch-size", "64", "--latent-dim", "8",
             "--no-tensorboard", "--seed", "3", "--epochs", "2", "--stn-lr", "1e-4",
             "--num-devices", "2", "--model-parallel", "2"]

    def run(name, *extra):
        return train_rvae.run_training(train_rvae.build_argparser().parse_args(
            [*small, "--checkpoint", str(tmp_path / name / "rvae.pt"), *extra]))

    straight = run("a")
    first = run("b", "--resume", "--stop-after-epochs", "1")
    state, meta = restore_train_state(tmp_path / "b" / "resume_rvae")
    one_device = RVAE(LATENT, 1, PATCH, device="cpu")
    one_device.load_state_dict(state["model"], strict=True)  # the whole model's weights
    shapes = {tuple(v["exp_avg"].shape) for v in state["optimizer"]["state"].values()}
    assert {(32, 2048), (8, 1024), (1024, 8), (1024,)} <= shapes  # the split layers, whole
    assert not shapes & {(32, 1024), (8, 512), (512, 8), (512,)}
    resumed = run("b", "--resume")
    assert meta["epoch"] == 0 and resumed["start_epoch"] == 1
    assert resumed["resumed_digest"] == first["epochs"][0]["digest"]
    assert [e["digest"] for e in straight["epochs"]] == [first["epochs"][0]["digest"],
                                                         resumed["epochs"][0]["digest"]]
    a = tc.load_checkpoint(tmp_path / "a" / "rvae_final.pt")["model_state"]
    b = tc.load_checkpoint(tmp_path / "b" / "rvae_final.pt")["model_state"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"param {k} diverged"
    assert resumed["epochs"][0]["metrics"] == straight["epochs"][1]["metrics"]
