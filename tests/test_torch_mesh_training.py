"""DP+TP DSM training of the PyTorch port on ``torch.distributed``: the
``data x model`` mesh step (``training/dsm.py::mesh_train_step``), the
tensor-parallel layout (``parallel/sharding.py``) and the train CLI's
``--mesh``, on gloo ranks on the CPU with K1's plain version.

Tiny widths: 2 layers, d_model 32, 4 heads of 8, Cp 16, FFN 64. One step
from spread flax weights (carried across by ``state_dict_from_jax``) on a
batch of 4 at L=10, the JAX package's noise for a JAX key (drawn as
``tests/test_torch_training.py`` draws it), AdamW + global-norm clip at the
trainer's default lr 1e-4. Tolerances:

(i)   ``data=2`` (an unmasked batch, and a masked one whose two halves hold
      20 and 12 real residues) against one process on the whole batch: the
      loss at rtol 1e-6, each clipped gradient within 1e-5 of its largest
      entry (f32, sums in another order) and the updated weights at atol
      1e-5. A first AdamW step moves each weight by lr g / (|g| + eps), so it
      magnifies the rounding of a gradient entry near eps = 1e-8 up to
      lr / (4 eps) times: the weights are held to a tenth of lr, the
      gradients carry the strict check;
(ii)  ``model=2`` (2 heads and 32 FFN units a rank) the same; every rank
      returns the same gathered weights and gradients bit for bit, so the
      replicated parameters stay equal across model ranks;
(iii) ``data=2,model=2`` on 4 ranks, and ``model=4`` (one head a rank),
      against one process at the same tolerances, and ``data=2,model=2``
      against JAX's ``make_sharded_dsm_train_step`` on a
      ``make_mesh(4, model_parallel=2)`` of the suite's virtual CPU devices
      (XLA attention, the optimizer chain of ``training/loop.py``): the loss
      at rtol 1e-5, as ``tests/test_torch_training.py`` holds the one-device
      loss, the updated weights at atol 1e-5, and the clipped gradients
      (ten times AdamW's first moment after JAX's step) within 1e-4 of each
      one's largest entry, as that file holds the one-device gradients
      against JAX's (another attention, another order of every sum);
(iv)  ``shard_state_dict`` then ``gather_state_dict`` gives the full state
      dict back bit for bit on 2- and 4-way model groups; each of JAX's 12
      TP rules names a port parameter and the same split;
(v)   the CLI with ``--mesh data=2,model=2 --device cpu`` (checkpoints
      gathered from the head groups and sharded back on resume): an
      interrupted run resumed equals the uninterrupted one bit for bit, and equals the
      one-device CLI's weights within 1e-5; its export loads in both packages'
      ``load_bundle``;
(vi)  ``--mesh`` on cuda with too few GPUs, a head split the card refuses,
      one that does not divide the heads and a batch smaller than the data
      axis exit before any rank starts.

Ranks import no JAX: their programs live in ``se3diff_torch.parallel.
programs``. Five spawns, each bounded by group and join timeouts.
"""

from datetime import timedelta
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import se3diff_torch.train as train_cli
from se3diff_torch.diffusion.denoise import SDEs as TorchSDEs
from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.parallel import launch, programs, run_ranks
from se3diff_torch.parallel.sharding import TP_RULES, split_dim
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchSO3
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchVP
from se3diff_torch.training import loop as tloop
from se3diff_torch.training.dsm import DSMNoise, dsm_loss, step_backward, step_update
from se3diff_tpu.diffusion.denoise import SDEs as JaxSDEs
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.parallel.mesh import make_mesh
from se3diff_tpu.parallel.sharding import _TP_RULES
from se3diff_tpu.sde.so3_sde import DiGSO3SDE as JaxSO3
from se3diff_tpu.sde.vpsde import CosineVPSDE as JaxVP
from se3diff_tpu.training import loop as jloop
from se3diff_tpu.training.dsm import make_sharded_dsm_train_step
from tests.test_torch_training import ENSEMBLES, MIN_T, SO3, TINY_MODEL_YAML, _jax_noise

W = dict(dim_model=32, dim_pair=16, num_layers=2, num_heads=4, dim_hidden=64, dropout=0.0)
B, L, LR = 4, 10, 1e-4
LOSS_RTOL_PORT, LOSS_RTOL_JAX, WEIGHT_ATOL = 1e-6, 1e-5, 1e-5
GRAD_RTOL_PORT, GRAD_RTOL_JAX = 1e-5, 1e-4
GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT = 150.0


def _spawn(tmp_path, fn, world, args):
    return run_ranks(fn, world, ["cpu"] * world, args=args, timeout=JOIN_TIMEOUT,
                     group_timeout=GROUP_TIMEOUT, rendezvous_dir=str(tmp_path))


def _batch(rng, masked: bool) -> dict[str, np.ndarray]:
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(B * L)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    batch = {
        "pos": (rng.standard_normal((B, L, 3)) * 0.5).astype(np.float32),
        "rot": rot.reshape(B, L, 3, 3).astype(np.float32),
        "single": (rng.standard_normal((B, L, 384)) * 0.5).astype(np.float32),
        "pair": (rng.standard_normal((B, L, L, 128)) * 0.3).astype(np.float32),
    }
    if masked:  # the data halves hold 10 + 10 and 7 + 5 real residues
        mask = np.ones((B, L), bool)
        mask[2, 7:] = mask[3, 5:] = False
        batch["mask"] = mask
    return batch


@pytest.fixture(scope="module")
def setup():
    """Spread flax weights, both batches, JAX's noise for each, the SDEs."""
    rng = np.random.default_rng(3)
    batches = {m: _batch(rng, m) for m in (False, True)}
    jb = {k: jnp.asarray(v[:1]) for k, v in batches[True].items()}
    flax_model = FlaxDiG(**W, use_pallas=False)
    variables = jax.jit(flax_model.init)(
        jax.random.key(0), jb["pos"], jb["rot"], jnp.ones((1,), jnp.float32), jb["single"],
        jb["pair"], jb["mask"],
    )
    variables = jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), variables)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    jsdes = JaxSDEs(pos=JaxVP(), node_orientations=JaxSO3(**SO3))
    key = jax.random.key(7)
    noise = {m: tuple(x.numpy() for x in _jax_noise(key, b, jsdes)) for m, b in batches.items()}
    return dict(flax_model=flax_model, variables=variables, sd=sd, batches=batches,
                noise=noise, jsdes=jsdes, key=key)


def _one_process(sd, batch, noise):
    """One-device reference: the train step's loss, backward and update on
    the whole batch with the given noise."""
    model = TorchDiG(**W)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    sdes = TorchSDEs(pos=TorchVP(), node_orientations=TorchSO3(**SO3))
    opt = tloop.make_optimizer(tloop.TrainConfig(lr=LR), model.parameters())
    model.eval()
    loss = dsm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                    DSMNoise(*map(torch.from_numpy, noise)), sdes)
    step_backward(opt, loss)
    step_update(model, opt, lr=LR, grad_clip=1.0)
    return (loss.item(), {k: v.numpy() for k, v in model.state_dict().items()},
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def _step(setup, data, model, masked):
    return (partial(programs.mesh_step, lr=LR),
            (data, model, W, setup["sd"], setup["batches"][masked], setup["noise"][masked], SO3))


def _same_on_every_rank(outs):
    for o in outs[1:]:
        assert o["loss"] == outs[0]["loss"]
        for key in ("weights", "grads"):
            for k, v in outs[0][key].items():
                np.testing.assert_array_equal(o[key][k], v, err_msg=k)


def _close(out, want_loss, want_weights, loss_rtol, want_grads=None, grad_rtol=GRAD_RTOL_PORT):
    np.testing.assert_allclose(out["loss"], want_loss, rtol=loss_rtol)
    assert set(out["weights"]) == set(want_weights)
    for k, w in want_weights.items():
        np.testing.assert_allclose(out["weights"][k], w, atol=WEIGHT_ATOL, rtol=0, err_msg=k)
    for k, g in (want_grads or {}).items():
        assert np.abs(g).max() > 0, k
        err = np.abs(out["grads"][k] - g).max()
        assert err <= grad_rtol * np.abs(g).max(), (k, err, np.abs(g).max())


def _round_trip_exact(outs, sd):
    for o in outs:
        assert set(o) == set(sd)
        for k, v in sd.items():
            assert o[k].tobytes() == v.tobytes(), k


def test_dp_and_tp_steps_on_two_ranks_match_one_process(tmp_path, setup):
    cases = [(2, 1, False), (2, 1, True), (1, 2, True)]
    steps = [_step(setup, *c) for c in cases]
    steps.append((programs.shard_round_trip, (1, 2, setup["sd"])))
    ranks = _spawn(tmp_path, programs.in_turn, 2, (steps,))
    for i, (data, model, masked) in enumerate(cases):
        outs = [r[i] for r in ranks]
        _same_on_every_rank(outs)
        loss, weights, grads = _one_process(setup["sd"], setup["batches"][masked],
                                            setup["noise"][masked])
        _close(outs[0], loss, weights, LOSS_RTOL_PORT, grads)
        for o in outs:   # CPU tensors take K1's plain version: no launch
            assert sum(o["launches_by_route"].values()) == 0
            assert o["backward_calls"] == W["num_layers"]
    _round_trip_exact([r[-1] for r in ranks], setup["sd"])


def test_dp_tp_step_on_four_ranks_matches_one_process_and_jax(tmp_path, setup):
    batch, noise = setup["batches"][True], setup["noise"][True]
    steps = [_step(setup, 2, 2, True), _step(setup, 1, 4, True),
             (programs.shard_round_trip, (1, 4, setup["sd"]))]
    ranks = _spawn(tmp_path, programs.in_turn, 4, (steps,))
    loss, weights, grads = _one_process(setup["sd"], batch, noise)
    for i in range(2):
        outs = [r[i] for r in ranks]
        _same_on_every_rank(outs)
        _close(outs[0], loss, weights, LOSS_RTOL_PORT, grads)
    _round_trip_exact([r[2] for r in ranks], setup["sd"])

    # JAX's DP+TP step on the same weights, batch and key.
    flax_model = setup["flax_model"]
    opt = jloop.make_optimizer(jloop.TrainConfig(lr=LR, grad_clip=1.0))
    step, place_params, place_batch = make_sharded_dsm_train_step(
        setup["jsdes"], flax_model.apply, opt, make_mesh(4, model_parallel=2),
        setup["variables"], min_t=MIN_T,
    )
    params = place_params(jax.tree.map(jnp.array, setup["variables"]))
    params, opt_state, loss = step(params, opt.init(params), setup["key"],
                                   place_batch({k: jnp.asarray(v) for k, v in batch.items()}))
    jax_weights = {k: v.numpy() for k, v in state_dict_from_jax(jax.device_get(params)).items()}
    # After a first step AdamW's first moment is (1 - b1) = 0.1 times the
    # clipped gradient: JAX's gradients, beside the weights that hold little
    # more than their signs.
    adam = opt_state[1][0]
    assert isinstance(adam, optax.ScaleByAdamState)
    jax_grads = {k: 10 * v.numpy() for k, v in state_dict_from_jax(jax.device_get(adam.mu)).items()
                 if v.numel()}   # not the step embedder's empty placeholder
    _close(ranks[0][0], float(loss), jax_weights, LOSS_RTOL_JAX, jax_grads, GRAD_RTOL_JAX)


def test_tp_rules_cover_jax_rules():
    model = TorchDiG(**W)
    names = [n for n, _ in model.named_parameters()]
    assert len(TP_RULES) == len(_TP_RULES) == 12
    for (jax_path, spec), (suffix, (path, dim)) in zip(_TP_RULES, TP_RULES.items()):
        assert path == jax_path
        # JAX's kernel [in, out] is the transpose of the port's weight [out, in].
        jax_dim = spec.index("model")
        assert dim == (jax_dim if len(spec) == 1 else 1 - jax_dim), suffix
        assert sum(n.endswith(suffix) for n in names) == W["num_layers"], suffix
    split = {n for n in names if split_dim(n) is not None}
    assert len(split) == 13 * W["num_layers"]   # the 12 rules and fc1's bias
    assert all(".encoder.layers." in n for n in split)
    # A TP model holds each split parameter's shard.
    mesh = type("Mesh", (), {"model": 2, "model_group": None})()
    shard = dict(TorchDiG(**W, tp=mesh).named_parameters())
    for n, p in model.named_parameters():
        want = list(p.shape)
        if split_dim(n) is not None:
            want[split_dim(n)] //= 2
        assert list(shard[n].shape) == want, n


def test_parse_mesh():
    assert train_cli.parse_mesh("data=2,model=4") == (2, 4)
    assert train_cli.parse_mesh("model=2") == (1, 2)
    assert train_cli.parse_mesh("data=3") == (3, 1)
    for bad in ("pipe=2", "data=0"):
        with pytest.raises(SystemExit):
            train_cli.parse_mesh(bad)


def _cli_argv(tmp_path, ckpt):
    (tmp_path / "model.yaml").write_text(TINY_MODEL_YAML)
    argv = [a for traj, top in ENSEMBLES for a in ("--trajectory", str(traj), "--topology", str(top))]
    return argv + ["--batch_size", "4", "--min_t", str(MIN_T), "--log_every", "1",
                   "--device", "cpu", "--model_config_path", str(tmp_path / "model.yaml"),
                   "--cache_embeds_dir", str(tmp_path / "embeds"), "--ckpt_dir", str(ckpt),
                   "--ckpt_every", "2", "--steps", "4", "--so3_cache_dir", str(tmp_path / "so3")]


def _params(ckpt):
    with np.load(ckpt / "params.npz") as sd:
        return {k: sd[k].copy() for k in sd.files}


def test_cli_mesh_resumes_bit_exact_and_exports_for_both_packages(tmp_path, monkeypatch):
    from se3diff_torch.sampling.bundle import load_bundle
    from se3diff_tpu.sampling.bundle import load_bundle as jax_load_bundle

    def bounded(fn, world, devices, args=()):
        return _spawn(tmp_path, fn, world, args)

    monkeypatch.setattr(launch, "run_ranks", bounded)
    full, part, one = tmp_path / "full", tmp_path / "part", tmp_path / "one"
    train_cli.main(_cli_argv(tmp_path, full) + ["--mesh", "data=2,model=2"])
    assert sorted(p.name for p in full.glob("step_*.pt")) == ["step_00000002.pt",
                                                              "step_00000004.pt"]
    # Interrupted at step 3's batch (after the step-2 checkpoint), then resumed.
    ranks = _spawn(tmp_path, programs.train_rank, 4, (_cli_argv(tmp_path, part), 2, 2, 3))
    assert [r["history"] for r in ranks] == [None] * 4
    assert not (part / "params.npz").exists()
    train_cli.main(_cli_argv(tmp_path, part) + ["--mesh", "data=2,model=2"])
    want = _params(full)
    got = _params(part)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].tobytes() == v.tobytes(), k

    train_cli.main(_cli_argv(tmp_path, one))   # one device, the same run
    for k, v in _params(one).items():
        np.testing.assert_allclose(want[k], v, atol=WEIGHT_ATOL, rtol=0, err_msg=k)

    bundle = load_bundle(full / "params.npz", device="cpu", so3_cache_dir=str(tmp_path / "so3"))
    jax_load_bundle(full / "params.npz", so3_cache_dir=str(tmp_path / "so3_jax"))
    with torch.no_grad():
        pos, rot = bundle.model(
            torch.zeros(1, 64, 3), torch.eye(3).expand(1, 64, 3, 3), torch.full((1,), 0.5),
            torch.randn(1, 64, 384), torch.randn(1, 64, 64, 128),
        )
    assert pos.shape == rot.shape == (1, 64, 3) and torch.isfinite(pos).all()


@pytest.mark.parametrize("mesh,match", [
    ("data=2", "GPUs"),               # too few GPUs for the ranks
    ("model=16", "heads"),            # 2 heads a rank: widths the card refuses
    ("model=3", "does not divide"),   # 32 heads do not split in 3
    ("data=16", "batch_size"),        # a batch of 8 does not split in 16
])
def test_cli_mesh_refuses_before_any_rank_starts(tmp_path, monkeypatch, mesh, match):
    if mesh == "data=2" and torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are visible; the error path needs fewer")

    def no_spawn(*a, **kw):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(launch, "run_ranks", no_spawn)
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["--trajectory", str(Path(tmp_path) / "none.pdb"), "--mesh", mesh,
                        "--device", "cuda"])
