"""DSM training in the PyTorch port against the JAX package.

Each piece runs in both packages on the same numpy inputs:
* ``frames_from_backbone`` (the same float64 numpy code: equal to 1e-7);
* both datasets' batches for the same seed (identical arrays);
* ``dsm_loss`` on the noise JAX draws inside its own ``dsm_loss`` (1e-5
  relative), and the gradient of every parameter, mapped by
  ``state_dict_from_jax``, at 1e-4 of the tensor's largest gradient. JAX
  runs its XLA attention (``use_pallas=False``), whose point distances add
  1e-12 under the square root where the port's add 1e-24 only at d2 <= 0: a
  relative difference of 1e-12/d2 per pair, far below the tolerance at
  these scales;
* the learning-rate schedule against optax (1e-6 relative: optax evaluates
  it in f32), and three AdamW + global-norm-clip steps against optax
  (1e-6 relative to the parameter scale).
The port alone: exact resume bit for bit, dropout off while training, and
the train CLI on the CPU, whose export loads in both packages.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.diffusion.denoise import SDEs as TorchSDEs
from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG, init_weights
from se3diff_torch.ops.so3 import rotvec_to_rotmat
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchSO3
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchVP
from se3diff_torch.struct.atoms import frames_from_atom37, frames_from_backbone
from se3diff_torch.training import data as tdata
from se3diff_torch.training import loop as tloop
from se3diff_torch.training.dsm import DSMNoise, clip_by_global_norm, dsm_loss, train_step
from se3diff_tpu.diffusion.denoise import SDEs as JaxSDEs
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.sde.so3_sde import DiGSO3SDE as JaxSO3
from se3diff_tpu.sde.vpsde import CosineVPSDE as JaxVP
from se3diff_tpu.struct.atoms import frames_from_atom37 as jax_frames_from_atom37
from se3diff_tpu.struct.atoms import frames_from_backbone as jax_frames_from_backbone
from se3diff_tpu.training import data as jdata
from se3diff_tpu.training import dsm as jdsm
from se3diff_tpu.training import loop as jloop

FIX = Path(__file__).parent / "test_data" / "samples_example"
ENSEMBLES = [
    (FIX / "md_emulation" / "cath1_1bl0A02.xtc", FIX / "md_emulation" / "cath1_1bl0A02.pdb"),
    (FIX / "folding_free_energies" / "test_1TG0.xtc", FIX / "folding_free_energies" / "test_1TG0.pdb"),
]
SO3 = dict(num_sigma=24, num_omega=128, l_max=100)
MIN_T = 0.15  # the small tables resolve the IGSO(3) series for t >= 0.15
SMALL = dict(dim_model=32, dim_pair=16, num_layers=2, num_heads=4, dim_hidden=32, dropout=0.1)
TINY = dict(dim_model=16, dim_pair=8, num_layers=1, num_heads=2, dim_hidden=16, dropout=0.0)


def test_frames_from_backbone_matches_jax(rng):
    n, ca, c = (rng.standard_normal((3, 7, 3)) * 3 for _ in range(3))
    for got, want in zip(frames_from_backbone(n, ca, c), jax_frames_from_backbone(n, ca, c)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-7)
    atom37 = rng.standard_normal((2, 5, 37, 3)) * 3
    for got, want in zip(frames_from_atom37(atom37), jax_frames_from_atom37(atom37)):
        np.testing.assert_allclose(got, want, atol=1e-7)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    kw = dict(bucket=32, embeds_backend="dummy")
    port = tdata.MultiEnsembleDataset.from_trajectories(
        ENSEMBLES, cache_embeds_dir=tmp_path_factory.mktemp("embeds_port"), **kw)
    ref = jdata.MultiEnsembleDataset.from_trajectories(
        ENSEMBLES, cache_embeds_dir=tmp_path_factory.mktemp("embeds_jax"), **kw)
    return port, ref


def _same_batch(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


def _batched(b: dict) -> dict:
    """A batch_fn batch with its unbatched conditioning tensors expanded."""
    B = len(b["pos"])
    return {k: v if k in ("pos", "rot") else v.expand(B, *v.shape) for k, v in b.items()}


def test_batches_equal_jax_for_the_same_seed(datasets):
    port, ref = datasets
    assert port.occupied_buckets() == ref.occupied_buckets() == [64]
    for seed in (0, 3):
        fp, fr = port.batch_fn(4, seed=seed, device="cpu"), ref.batch_fn(4, seed=seed)
        for step in (0, 1, 7):
            b = fp(step)
            assert isinstance(b["pair"], torch.Tensor) and b["pair"].ndim == 3
            _same_batch(_batched(b), fr(step))
    # One ensemble, epoch permutations.
    fp = port.datasets[0].batch_fn(2, seed=1, device="cpu")
    fr = ref.datasets[0].batch_fn(2, seed=1)
    for step in range(5):
        _same_batch(_batched(fp(step)), fr(step))
    # The numpy form.
    _same_batch(port.batch(*_draw(ref, 3, seed=2, step=4)), ref.batch(*_draw(ref, 3, seed=2, step=4)))


def test_conditioning_shape_mismatch_raises():
    traj, top = ENSEMBLES[0]
    with pytest.raises(ValueError, match="conditioning shapes"):
        tdata.EnsembleDataset.from_trajectory(
            traj, top, single=np.zeros((3, 8), np.float32), pair=np.zeros((3, 3, 4), np.float32))


def _draw(mds, batch_size, seed, step):
    """The JAX batch_fn's (system, idx) draw for ``step``."""
    w = np.array([d.num_frames for d in mds.datasets], np.float64)
    r = np.random.default_rng((seed, step))
    system = int(r.choice(len(mds.datasets), p=w / w.sum()))
    F = mds.datasets[system].num_frames
    return system, r.choice(F, size=batch_size, replace=batch_size > F)


@pytest.fixture(scope="module")
def loss_setup(datasets):
    """A padded real-ensemble batch (60 residues in a 64 bucket), a small
    flax model with spread weights, and the port's copy of it."""
    _, ref = datasets
    batch = {k: np.ascontiguousarray(v) for k, v in ref.batch(0, np.array([0, 3])).items()}
    flax_model = FlaxDiG(**SMALL, use_pallas=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(flax_model.init)(
        jax.random.key(0), jb["pos"][:1], jb["rot"][:1], jnp.ones((1,), jnp.float32),
        jb["single"][:1], jb["pair"][:1], jb["mask"][:1],
    )
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), params)
    port = TorchDiG(**SMALL)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    jsdes = JaxSDEs(pos=JaxVP(), node_orientations=JaxSO3(**SO3))
    tsdes = TorchSDEs(pos=TorchVP(), node_orientations=TorchSO3(**SO3))
    return batch, flax_model, params, port, jsdes, tsdes


def _jax_noise(key, batch, sdes):
    """The noise JAX's dsm_loss draws from ``key`` (training/dsm.py:68-78)."""
    k_t, k_pos, k_rot = jax.random.split(key, 3)
    pos0 = jnp.asarray(batch["pos"])
    t = jax.random.uniform(k_t, (pos0.shape[0],), pos0.dtype, MIN_T, 1.0)
    z = jax.random.normal(k_pos, pos0.shape, pos0.dtype)
    rot_t = sdes.node_orientations.sample_marginal(k_rot, jnp.asarray(batch["rot"]), t)
    return DSMNoise(*(torch.from_numpy(np.array(x, np.float32)) for x in (t, z, rot_t)))


def test_dsm_loss_and_gradients_match_jax(loss_setup):
    batch, flax_model, params, port, jsdes, tsdes = loss_setup
    key = jax.random.key(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jdsm.dsm_loss(p, key, jb, jsdes, flax_model.apply, min_t=MIN_T)
    ))(params)
    port.zero_grad()
    port.eval()
    loss = dsm_loss(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                    _jax_noise(key, batch, jsdes), tsdes)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax(want_grads)
    checked = 0
    for name, p in port.named_parameters():
        w = want[name]
        assert p.grad is not None and p.grad.abs().max() > 0, name
        err = (p.grad - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err, w.abs().max().item())
        checked += 1
    assert checked == len(list(port.parameters()))


def test_padded_rows_do_not_leak_into_the_loss(loss_setup):
    batch, _, _, port, jsdes, tsdes = loss_setup
    noise = _jax_noise(jax.random.key(3), batch, jsdes)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    messed = dict(tb, pos=tb["pos"].clone(), rot=tb["rot"].clone())
    messed["pos"][:, 60:] = 37.0
    messed["rot"][:, 60:] = rotvec_to_rotmat(torch.randn(2, 4, 3, generator=torch.Generator().manual_seed(0)))
    rot_t = noise.rot_t.clone()
    rot_t[:, 60:] = messed["rot"][:, 60:]
    port.eval()
    with torch.no_grad():
        a = dsm_loss(port, tb, noise, tsdes).item()
        b = dsm_loss(port, messed, noise._replace(rot_t=rot_t), tsdes).item()
    assert np.isfinite(a) and a == pytest.approx(b, rel=1e-6)


@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches_optax(warmup):
    kw = dict(num_steps=100, lr=3e-4, warmup_steps=warmup, eta_min_ratio=0.05)
    got, want = tloop.make_schedule(tloop.TrainConfig(**kw)), jloop.make_schedule(jloop.TrainConfig(**kw))
    for c in (0, 1, warmup, warmup + 1, 55, 99, 100, 130):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6, atol=1e-12, err_msg=str(c))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # below and above the clip
def test_adamw_and_clip_steps_match_optax(rng, grad_scale):
    kw = dict(num_steps=10, lr=1e-2, warmup_steps=1, weight_decay=0.05, grad_clip=1.0)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]

    tx = jloop.make_optimizer(jloop.TrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)

    cfg = tloop.TrainConfig(**kw)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = tloop.make_optimizer(cfg, list(tp.values())), tloop.make_schedule(cfg)
    for c, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_by_global_norm([p.grad for p in tp.values()], cfg.grad_clip)
        for group in opt.param_groups:
            group["lr"] = sched(c)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def _toy_setup():
    model = init_weights(TorchDiG(**TINY), torch.Generator().manual_seed(0))
    sdes = TorchSDEs(pos=TorchVP(), node_orientations=TorchSO3(**SO3))

    def batch_fn(step):
        rng = np.random.default_rng(step)
        B, L = 3, 6
        return {
            "pos": (rng.standard_normal((B, L, 3)) * 0.5).astype(np.float32),
            "rot": rotvec_to_rotmat(torch.from_numpy(rng.standard_normal((B, L, 3)) * 0.3).float()).numpy(),
            "single": rng.standard_normal((L, 384)).astype(np.float32),
            "pair": (rng.standard_normal((L, L, 128)) * 0.3).astype(np.float32),
        }

    return model, sdes, batch_fn


def test_resume_is_bit_exact_and_logs_append(tmp_path):
    model, sdes, batch_fn = _toy_setup()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = dict(num_steps=6, lr=1e-3, log_every=2, min_t=MIN_T, ckpt_every=2, max_ckpts_kept=2)

    full, _ = tloop.train_dsm(sdes, model, batch_fn, tloop.TrainConfig(**cfg, ckpt_dir=str(tmp_path / "full")))
    want = {k: v.clone() for k, v in full.state_dict().items()}

    def interrupting(step):
        if step == 5:
            raise KeyboardInterrupt
        return batch_fn(step)

    part = tloop.TrainConfig(**cfg, ckpt_dir=str(tmp_path / "part"))
    model.load_state_dict(init)
    with pytest.raises(KeyboardInterrupt):
        tloop.train_dsm(sdes, model, interrupting, part)
    assert sorted(p.name for p in (tmp_path / "part").glob("step_*.pt")) == [
        "step_00000002.pt", "step_00000004.pt"]
    model.load_state_dict(init)  # a fresh process: weights come from the checkpoint
    resumed, _ = tloop.train_dsm(sdes, model, batch_fn, part)
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert len(list((tmp_path / "part").glob("step_*.pt"))) == 2  # max_ckpts_kept
    recs = [json.loads(x) for x in (tmp_path / "part" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4, 6]
    assert all(r["lr"] > 0 and np.isfinite(r["loss"]) for r in recs)


def test_validation_runs_on_its_own_noise():
    model, sdes, batch_fn = _toy_setup()
    cfg = tloop.TrainConfig(num_steps=4, lr=1e-3, log_every=1, min_t=MIN_T, val_every=2)
    _, hist = tloop.train_dsm(sdes, model, batch_fn, cfg, val_batch=batch_fn(999))
    assert len(hist) == 4 and np.isfinite(hist).all()


def test_training_runs_with_dropout_off():
    """A step of a model declared with dropout 0.9 equals the same step of
    its dropout-free twin: the JAX package trains deterministically."""
    model, sdes, batch_fn = _toy_setup()
    noisy = TorchDiG(**dict(TINY, dropout=0.9))
    noisy.load_state_dict(model.state_dict())
    noisy.train()
    batch = tloop._to_device(batch_fn(0), torch.device("cpu"))
    cfg = tloop.TrainConfig(lr=1e-2)
    for m in (model, noisy):
        train_step(m, tloop.make_optimizer(cfg, m.parameters()), batch,
                   tloop.step_generator(0, 0, torch.device("cpu")), sdes, lr=1e-2, min_t=MIN_T)
    assert not noisy.training
    for (k, a), b in zip(model.state_dict().items(), noisy.state_dict().values()):
        assert torch.equal(a, b), k


TINY_MODEL_YAML = """
score_model:
  _target_: bioemu.shortcuts.DiGConditionalScoreModel
  dim_hidden: 16
  dim_model: 16
  dim_pair: 8
  dropout: 0.0
  num_heads: 2
  num_layers: 1
sdes:
  node_orientations:
    _target_: bioemu.shortcuts.DiGSO3SDE
    eps_t: 0.001
    l_max: 100
    num_omega: 128
    num_sigma: 24
    sigma_max: 1.65
    sigma_min: 0.02
    tol: 1.0e-07
  pos:
    _target_: bioemu.shortcuts.CosineVPSDE
    s: 0.008
"""


def test_train_cli_on_cpu_exports_for_both_packages(tmp_path):
    import se3diff_torch.train as train_cli
    from se3diff_torch.sampling.bundle import load_bundle
    from se3diff_tpu.sampling.bundle import load_bundle as jax_load_bundle

    (tmp_path / "model.yaml").write_text(TINY_MODEL_YAML)
    ckpt = tmp_path / "ckpt"
    argv = [a for traj, top in ENSEMBLES for a in ("--trajectory", str(traj), "--topology", str(top))]
    argv += ["--batch_size", "2", "--min_t", str(MIN_T), "--log_every", "1", "--device", "cpu",
             "--model_config_path", str(tmp_path / "model.yaml"),
             "--cache_embeds_dir", str(tmp_path / "embeds"), "--ckpt_dir", str(ckpt),
             "--ckpt_every", "2"]
    train_cli.main(argv + ["--steps", "4"])
    assert (ckpt / "step_00000004.pt").exists() and (ckpt / "config.yaml").exists()
    with np.load(ckpt / "params.npz") as sd:
        first = {k: sd[k].copy() for k in sd.files}
    assert any(k.startswith("model_nn.") for k in first)

    bundle = load_bundle(ckpt / "params.npz", device="cpu", so3_cache_dir=str(tmp_path / "so3"))
    jax_load_bundle(ckpt / "params.npz", so3_cache_dir=str(tmp_path / "so3_jax"))
    L = 64
    with torch.no_grad():
        pos, rot = bundle.model(
            torch.zeros(1, L, 3), torch.eye(3).expand(1, L, 3, 3), torch.full((1,), 0.5),
            torch.randn(1, L, 384), torch.randn(1, L, L, 128),
        )
    assert pos.shape == rot.shape == (1, L, 3) and torch.isfinite(pos).all()

    train_cli.main(argv + ["--steps", "6"])  # resumes from step 4
    with np.load(ckpt / "params.npz") as sd:
        assert any(not np.array_equal(first[k], sd[k]) for k in first)
