"""Data parallelism of the port (livae_tpu_torch.parallel) on 2 gloo ranks on
the CPU, against the port's single-process step and livae_tpu's single-device
step (`mesh=None`), at f32 (patch 32, latent 8, global batch 16).

The ranks are spawned processes meeting through a file store under tmp_path;
each trains on its 8 rows of the global batch, whose augmentation draws and
noise are injected: derived from the JAX step's key as the JAX package
derives them, the noise fed to JAX through a monkeypatched
`reparameterize`. The JAX package's own mesh test holds its sharded step to
the single-device one at loss rtol 1e-5 and params atol 2e-5; the two-rank
port is held to its single-process step at 1e-5 (the order of float32 sums
differs; see `_assert_equal_within` for Adam's flips), and to JAX within the
bounds of tests/test_torch_engine.py.

This module is imported by the spawned ranks: JAX is imported inside the
tests only.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from livae_tpu_torch.data.pipeline import AugmentConfig, PairedDraws
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.parallel import mesh as pm
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train.state import make_optimizer

PATCH, LATENT, PAD, B, STEPS = 32, 8, 8, 16, 2
MARGIN = (PATCH + 2 * PAD + 16) // 2 + 8
BETA, GAMMA = 10.0, 10.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread here and in every rank (spawn passes it on)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steps(mesh, device, kind, state, table, idx, draws, eps, use_diversity, gather=True):
    """STEPS fused train steps of a model loaded from `state`; on a rank
    (`mesh`) or in this process (mesh None). Returns the step means and the
    weights after."""
    if not gather:  # the diversity term on each rank's own rows only
        te.gather_rows = lambda x, mesh, differentiable=False: (
            x if differentiable else pm.gather_rows(x, mesh))
    model = (RVAE if kind == "rvae" else VAE)(LATENT, 1, PATCH, device="cpu")
    model.load_state_dict(state)
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
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def _two_ranks(tmp_path, *args):
    return pm.spawn(_steps, 2, *args, device_type="cpu", root=tmp_path)


@pytest.fixture
def sites(rng):
    """Two random frames, 40 sites, and STEPS global batches of distinct sites."""
    N, H, W, n = 2, 120, 140, 40
    raw = rng.random((N, H, W)).astype(np.float32)
    coords = np.stack([rng.uniform(20, H - 20, n), rng.uniform(20, W - 20, n)],
                      axis=1).astype(np.float32)
    img_idx = rng.integers(0, N, n).astype(np.int32)
    idx = rng.permutation(n)[: STEPS * B].reshape(STEPS, B).astype(np.int32)
    ttable = (torch.nn.functional.pad(torch.from_numpy(raw), (MARGIN,) * 4),
              torch.from_numpy(img_idx).long(), torch.from_numpy(coords))
    return raw, img_idx, coords, idx, ttable


def _jax_run(kind, sites, use_diversity, rng, monkeypatch):
    """livae_tpu's fused step (mesh=None) on the same sites: its step means,
    its weights after (in the port's layout), the starting weights, and the
    draws and noise it used."""
    import jax
    import jax.numpy as jnp

    import livae_tpu.models.rvae as jrvae
    import livae_tpu.models.vae as jvae
    from livae_tpu.data.pipeline import AugmentConfig as JAugmentConfig
    from livae_tpu.data.pipeline import _sample_aug, pad_frames
    from livae_tpu.models import init_params
    from livae_tpu.train import engine as je
    from livae_tpu.train.state import TrainState
    from livae_tpu.train.state import make_optimizer as jax_optimizer
    from livae_tpu_torch.utils.checkpoint import load_jax_params

    queue = []

    def reparameterize(key, mu, logvar):
        e = jax.pure_callback(lambda _: queue.pop(0), jax.ShapeDtypeStruct(mu.shape, mu.dtype),
                              jax.lax.stop_gradient(mu))
        return mu + e * jnp.exp(0.5 * logvar)

    monkeypatch.setattr(jvae, "reparameterize", reparameterize)
    monkeypatch.setattr(jrvae, "reparameterize", reparameterize)
    raw, img_idx, coords, idx, _ = sites
    jcls, tcls = (jrvae.RVAE, RVAE) if kind == "rvae" else (jvae.VAE, VAE)
    jmodel = jcls(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, PATCH, PATCH, 1)))

    def port_state(p):
        model = tcls(LATENT, 1, PATCH, device="cpu")
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, p))
        return model.state_dict()

    start = port_state(params)
    eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(STEPS)]
    queue.extend(eps)
    cfg, key = JAugmentConfig(), jax.random.key(7)
    kw = dict(patch_size=PATCH, padding=PAD, cfg=cfg, margin=MARGIN,
              use_diversity=use_diversity)
    if kind == "rvae":
        tx = jax_optimizer(1e-3, optimizer="adamw", weight_decay=1e-5)
        jstep = je.make_fused_rvae_train_step(jmodel, tx, canonical_weight=0.2,
                                              grad_max_norm=20.0, **kw)
    else:
        tx = jax_optimizer(1e-3, optimizer="adam")
        jstep = je.make_fused_vae_train_step(jmodel, tx, grad_max_norm=5.0, **kw)
    state = TrainState.create(jax.tree_util.tree_map(jnp.array, params), tx)
    state, want = jstep(state, pad_frames(jnp.asarray(raw), MARGIN), jnp.asarray(img_idx),
                        jnp.asarray(coords), jnp.asarray(idx), key, BETA, GAMMA)
    want = je.metrics_to_host(want)
    assert not queue

    draws = []
    for i in range(STEPS):  # engine.py: fold_in(key, i) -> (ke, ks)
        ke, _ = jax.random.split(jax.random.fold_in(key, i))
        if kind == "rvae":  # the paired extraction: ke -> (kaug, kangle)
            kaug, kangle = jax.random.split(ke)
            scale, _, fh, fv, jy, jx = (np.array(v) for v in _sample_aug(kaug, B, cfg))
            angle = np.array(jax.random.uniform(kangle, (B,), minval=0.0, maxval=2 * jnp.pi))
        else:
            scale, angle, fh, fv, jy, jx = (np.array(v) for v in _sample_aug(ke, B, cfg))
        t = torch.from_numpy
        draws.append(PairedDraws(t(scale), t(fh), t(fv), t(jy).long(), t(jx).long(), t(angle)))
    return want, port_state(state.params), start, draws, [torch.from_numpy(e) for e in eps]


def _assert_like_jax(got, want, jstate):
    """The bounds of tests/test_torch_engine.py: step means at rtol 1e-3, the
    weights within 2 lr per step, all but 0.1 % of elements within 1e-4."""
    assert set(got["metrics"]) == set(want)
    for k in want:
        np.testing.assert_allclose(got["metrics"][k], want[k], atol=2e-4, rtol=1e-3, err_msg=k)
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k].numpy()).ravel()
                            for k, v in got["state"].items()])
    assert diffs.max() <= 2 * 1e-3 * STEPS
    assert np.mean(diffs > 1e-4) < 1e-3


def _assert_equal_within(a, b, tol):
    """Step means within `tol`; weights within `tol` but for Adam's flips: its
    first steps move an element by about lr whatever its gradient's size, so
    where a gradient is near 0 the float32 rounding of the two runs' sums
    (one batch, or two halves averaged) can send it the other way. Such
    elements stay within 2 lr per step and are fewer than 0.1 % (0.017 % seen
    with the diversity term)."""
    for k in a["metrics"]:
        np.testing.assert_allclose(a["metrics"][k], b["metrics"][k], atol=tol, rtol=tol,
                                   err_msg=k)
    diffs = np.concatenate([np.abs(v.numpy() - b["state"][k].numpy()).ravel()
                            for k, v in a["state"].items()])
    assert diffs.max() <= 2 * 1e-3 * STEPS
    assert np.mean(diffs > tol) < 1e-3


@pytest.mark.parametrize("kind,use_diversity", [("rvae", False), ("rvae", True),
                                                ("vae", False)],
                         ids=["rvae", "rvae_diversity", "vae"])
def test_two_ranks_step_as_one_device(tmp_path, sites, rng, monkeypatch, kind, use_diversity):
    """Two fused train steps on 2 ranks against the port in one process
    (within 1e-5) and against livae_tpu's single-device step."""
    want, jstate, start, draws, eps = _jax_run(kind, sites, use_diversity, rng, monkeypatch)
    args = (kind, start, sites[4], torch.from_numpy(sites[3]).long(), draws, eps,
            use_diversity)
    two = _two_ranks(tmp_path, *args)
    one = _steps(None, torch.device("cpu"), *args)
    _assert_equal_within(two, one, 1e-5)
    _assert_like_jax(two, want, jstate)
    _assert_like_jax(one, want, jstate)
    assert not list(tmp_path.iterdir())  # the rendezvous directory is removed


def test_diversity_needs_the_gathered_batch(tmp_path, sites):
    """Without the gather each rank's diversity term is the std of its own 8
    angles, and the run is no longer the one-device run."""
    model = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    draws = [te.sample_paired_draws(B, AugmentConfig(), g, "cpu") for _ in range(STEPS)]
    eps = [torch.randn((B, LATENT), generator=g) for _ in range(STEPS)]
    args = ("rvae", model.state_dict(), sites[4], torch.from_numpy(sites[3]).long(), draws,
            eps, True)
    one = _steps(None, torch.device("cpu"), *args)
    gathered = _two_ranks(tmp_path, *args)
    local = _two_ranks(tmp_path, *args, False)
    _assert_equal_within(gathered, one, 1e-5)
    off = abs(float(local["metrics"]["cycle_loss"]) - float(one["metrics"]["cycle_loss"]))
    assert off > 1e-3 * abs(float(one["metrics"]["cycle_loss"])), off
    assert not all(torch.allclose(v, one["state"][k], atol=1e-5)
                   for k, v in local["state"].items())


@pytest.mark.parametrize("spec,device_type,want", [
    (None, "cpu", 1), ("1", "cpu", 1), ("2", "cpu", 2), (3, "cpu", 3), ("auto", "cpu", 1),
    ("AUTO", "cpu", 1),
])
def test_resolve_num_devices(spec, device_type, want):
    assert pm.resolve_num_devices(spec, device_type) == want


def test_resolve_num_devices_auto_on_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pm.resolve_num_devices("auto") == 4
    with pytest.raises(ValueError, match=">= 1"):
        pm.resolve_num_devices("0")


@pytest.mark.parametrize("flags,match", [
    (("2", 1, 15, "cpu"), "--batch-size 15 must be divisible"),
    (("3", 1, 16, "cuda"), "Requested 3 devices but only 2 available"),
    (("1", 2, 16, "cpu"), "--num-devices 1 must be divisible by --model-parallel 2"),
    (("4", 2, 16, "cuda"), "Requested 4 devices but only 2 available"),
])
def test_setup_mesh_exits(monkeypatch, flags, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match=match):
        pm.setup_mesh_from_flags(*flags)


def test_setup_mesh_counts_the_ranks(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm.setup_mesh_from_flags("1", 1, 15, "cpu") == (1, 1)  # no mesh: any batch
    assert capsys.readouterr().out == ""
    assert pm.setup_mesh_from_flags("auto", 1, 16, "cuda") == (2, 1)
    assert "Data-parallel mesh: 2 cuda ranks" in capsys.readouterr().out


def test_shard_and_gather_without_a_mesh_are_identities():
    x = torch.arange(12.0).reshape(6, 2)
    assert pm.shard_batch(x, None) is x and pm.gather_rows(x, None) is x
    assert pm.all_reduce_mean(x, None) is x
    rows = pm.shard_batch(x, pm.DataMesh(1, 3))
    assert torch.equal(rows, x[2:4])
    with pytest.raises(ValueError, match="cannot be shared"):
        pm.shard_batch(x, pm.DataMesh(0, 4))


def _recording_train(mesh, device, args):
    """train_rvae's rank body with its checkpoint writer and its profiler
    recording who wrote."""
    from livae_tpu_torch.scripts import train_rvae

    save, profile = train_rvae.save_reference_checkpoint, train_rvae.profile_epoch

    def recorded(path, *a, **k):
        with open(f"{path}.writers", "a") as f:
            f.write(f"{mesh.rank}\n")
        return save(path, *a, **k)

    def recorded_profile(enabled, log_dir, device):
        if enabled:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            with open(Path(log_dir) / "profile.writers", "a") as f:
                f.write(f"{mesh.rank}\n")
        return profile(enabled, log_dir, device)

    train_rvae.save_reference_checkpoint = recorded
    train_rvae.profile_epoch = recorded_profile
    return train_rvae._train(mesh, device, args)


def test_train_rvae_profiles_on_rank_0_alone(tmp_path, capfd):
    """`--profile` under `--num-devices 2`: rank 0 alone traces the second
    epoch and writes `<log-dir>/profile/trace.json`, once."""
    from livae_tpu_torch.scripts import _common, train_rvae

    log_dir = tmp_path / "logs"
    args = train_rvae.build_argparser().parse_args([
        "--cpu", "--no-amp", "--synthetic", "1", "--synthetic-size", "512",
        "--patch-size", "32", "--padding", "8", "--batch-size", "64", "--latent-dim", "8",
        "--no-tensorboard", "--epochs", "2", "--val-split", "0.2", "--seed", "3",
        "--num-devices", "2", "--profile", "--log-dir", str(log_dir),
        "--checkpoint", str(tmp_path / "ckpt" / "rvae.pt")])
    _common.run_data_parallel(_recording_train, args, torch.device("cpu"))
    out = capfd.readouterr().out
    assert (log_dir / "profile.writers").read_text() == "0\n"
    assert sorted(p.name for p in (log_dir / "profile").iterdir()) == ["trace.json"]
    json.loads((log_dir / "profile" / "trace.json").read_text())
    assert out.count("Profiler trace written") == 1


def test_train_rvae_on_two_ranks(tmp_path, capfd):
    """`train_rvae --cpu --num-devices 2` for one epoch: the epoch's metrics
    those of one process, rank 0 alone writes each checkpoint, once, and
    prints. Over the epoch's 7 steps Adam's flips (`_assert_equal_within`)
    move the later gradients by up to 1.4e-5 of their norm, so the epoch
    means are held at rtol 1e-4."""
    from livae_tpu_torch.scripts import _common, train_rvae

    small = ["--cpu", "--no-amp", "--synthetic", "1", "--synthetic-size", "512",
             "--patch-size", "32", "--padding", "8", "--batch-size", "64", "--latent-dim", "8",
             "--no-tensorboard", "--epochs", "1", "--val-split", "0.2", "--seed", "3"]
    one = train_rvae.run_training(train_rvae.build_argparser().parse_args(
        [*small, "--checkpoint", str(tmp_path / "one" / "rvae.pt")]))
    capfd.readouterr()
    ckpt = tmp_path / "two" / "rvae.pt"
    args = train_rvae.build_argparser().parse_args(
        [*small, "--num-devices", "2", "--checkpoint", str(ckpt)])
    two = _common.run_data_parallel(_recording_train, args, torch.device("cpu"))
    out = capfd.readouterr().out
    assert out.count("Data-parallel mesh: 2 cpu ranks") == 1
    assert out.count("Epoch 1/1") == 1 and out.count("saved best checkpoint") == 1
    for path in (ckpt, ckpt.with_name("rvae_final.pt")):
        assert path.exists()
        assert path.with_name(path.name + ".writers").read_text() == "0\n"
    assert sorted(p.name for p in ckpt.parent.iterdir()) == [
        "rvae.pt", "rvae.pt.writers", "rvae_final.pt", "rvae_final.pt.writers"]
    m1, m2 = one["epochs"][0]["metrics"], two["epochs"][0]["metrics"]
    assert set(m1) == set(m2)
    for k in m1:  # 118 val sites at batch 64: one batch and a tail of 54 in both runs
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert "optimizer" not in two and isinstance(two["model"], RVAE)
