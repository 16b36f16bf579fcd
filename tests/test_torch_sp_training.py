"""Sequence-parallel (SP) DSM training of the PyTorch port on gloo ranks:
``parallel/mesh.py::gather_rows``' gradient and
``training/dsm.py::sp_train_step``, with K1's plain version on the CPU.

(i)  ``gather_rows`` under autograd (a fault of the port before its backward
     existed: the in-place ``all_reduce`` was invisible to autograd, so a
     rank kept only its own partial gradient). Two ranks run ``y = W[slab]
     @ x``, a gather, ``z = W[slab] @ y``, a gather, loss ``sum(z^2) /
     world``; the input and weight gradients summed over the ranks equal
     one process's within 1e-4 of each one's largest entry.
(ii) One SP DSM step (the model built with ``sp``) on 2 and 4 ranks at
     L=11 (ragged slabs: 6 + 5 and 3 + 3 + 3 + 2 rows), one masked column,
     from spread flax weights (carried across by ``state_dict_from_jax``),
     with the JAX package's noise for a JAX key. Held per parameter at
     ``test_sp_fused_grads_match``'s tolerance, ``1e-4 * max(1, |g|max)``,
     against one process of the port, against JAX's gradient of the same
     loss on the same weights, and against JAX's ``pair_sharding`` model
     (rows split over 4 of the suite's 8 virtual CPU devices; XLA
     attention, which the Pallas interpreter would take a minute to
     replace). The gradients compared are the step's, clipped by their
     global norm (JAX's clipped the same way here); the loss at rtol 1e-5;
     every rank ends with the same gradients and weights bit for bit.

Ranks import no JAX: their programs live in ``se3diff_torch.parallel.
programs``. Two spawns, each bounded by group and join timeouts.
"""

from datetime import timedelta
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from se3diff_torch.diffusion.denoise import SDEs as TorchSDEs
from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.parallel import programs, run_ranks
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchSO3
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchVP
from se3diff_torch.training.dsm import DSMNoise, clip_by_global_norm, dsm_loss
from se3diff_tpu.diffusion.denoise import SDEs as JaxSDEs
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.sde.so3_sde import DiGSO3SDE as JaxSO3
from se3diff_tpu.sde.vpsde import CosineVPSDE as JaxVP
from se3diff_tpu.training import dsm as jdsm
from tests.test_torch_training import MIN_T, SO3, _jax_noise

W = dict(dim_model=32, dim_pair=16, num_layers=2, num_heads=4, dim_hidden=64, dropout=0.0)
B, L, LR = 4, 11, 1e-4
GRAD_RTOL, LOSS_RTOL, PROBE_RTOL = 1e-4, 1e-5, 1e-4
GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT = 150.0


def _spawn(tmp_path, fn, world, args):
    return run_ranks(fn, world, ["cpu"] * world, args=args, timeout=JOIN_TIMEOUT,
                     group_timeout=GROUP_TIMEOUT, rendezvous_dir=str(tmp_path))


def test_gather_rows_gradient_sums_every_ranks_contribution(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((7, 7)).astype(np.float32)
    x = rng.standard_normal((7, 3)).astype(np.float32)
    ranks = _spawn(tmp_path, programs.gather_rows_probe, 2, (w, x))
    W_, X_ = torch.tensor(w, requires_grad=True), torch.tensor(x, requires_grad=True)
    z = W_ @ (W_ @ X_)
    z.square().sum().backward()
    for r in ranks:
        np.testing.assert_array_equal(r["z"], ranks[0]["z"])
    np.testing.assert_allclose(ranks[0]["z"], z.detach().numpy(), rtol=1e-5, atol=1e-5)
    for key, want in (("w", W_.grad.numpy()), ("x", X_.grad.numpy())):
        got = sum(r[key] for r in ranks)
        err = np.abs(got - want).max()
        assert err <= PROBE_RTOL * np.abs(want).max(), (key, err, np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    """Spread flax weights, a batch with one masked column, JAX's noise for
    a key, and the three references' clipped gradients."""
    rng = np.random.default_rng(5)
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(B * L)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    mask = np.ones((B, L), bool)
    mask[:, 4] = False
    batch = {
        "pos": (rng.standard_normal((B, L, 3)) * 0.5).astype(np.float32),
        "rot": rot.reshape(B, L, 3, 3).astype(np.float32),
        "single": (rng.standard_normal((B, L, 384)) * 0.5).astype(np.float32),
        "pair": (rng.standard_normal((B, L, L, 128)) * 0.3).astype(np.float32),
        "mask": mask,
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax_model = FlaxDiG(**W, use_pallas=False)
    variables = jax.jit(flax_model.init)(
        jax.random.key(0), jb["pos"][:1], jb["rot"][:1], jnp.ones((1,), jnp.float32),
        jb["single"][:1], jb["pair"][:1], jb["mask"][:1],
    )
    variables = jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), variables)
    jsdes = JaxSDEs(pos=JaxVP(), node_orientations=JaxSO3(**SO3))
    key = jax.random.key(9)
    noise = tuple(x.numpy() for x in _jax_noise(key, batch, jsdes))

    def jax_grads(model):
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: jdsm.dsm_loss(p, key, jb, jsdes, model.apply, min_t=MIN_T)))(variables)
        g = {k: v.numpy() for k, v in state_dict_from_jax(jax.device_get(g)).items() if v.numel()}
        return float(loss), _clipped(g)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    sharded = FlaxDiG(**W, use_pallas=False, pair_sharding=NamedSharding(mesh, P(None, "model")))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    return dict(sd=sd, batch=batch, noise=noise, one=_one_process(sd, batch, noise),
                jax=jax_grads(flax_model), jax_sp=jax_grads(sharded))


def _clipped(grads: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for g in grads.values()))
    return {k: g * min(1.0, 1.0 / norm) for k, g in grads.items()}


def _one_process(sd, batch, noise):
    model = TorchDiG(**W).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    sdes = TorchSDEs(pos=TorchVP(), node_orientations=TorchSO3(**SO3))
    loss = dsm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                    DSMNoise(*map(torch.from_numpy, noise)), sdes)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    clip_by_global_norm(grads, 1.0)
    return loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters()}


def _close_grads(got, want, label):
    for k, g in want.items():
        err = np.abs(got[k] - g).max()
        assert err <= GRAD_RTOL * max(1.0, np.abs(g).max()), (label, k, err, np.abs(g).max())


@pytest.mark.parametrize("world", [2, 4])
def test_sp_step_matches_one_process_and_jax(tmp_path, setup, world):
    step = partial(programs.sp_step, lr=LR)
    ranks = _spawn(tmp_path, step, world,
                   (W, setup["sd"], setup["batch"], setup["noise"], SO3))
    assert [r["rows"] for r in ranks] == (
        [(0, 6), (6, 11)] if world == 2 else [(0, 3), (3, 6), (6, 9), (9, 11)])
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for key in ("grads", "weights"):
            for k, v in ranks[0][key].items():
                np.testing.assert_array_equal(r[key][k], v, err_msg=k)
    for r in ranks:   # CPU tensors take K1's plain version: no launch
        assert sum(r["launches_by_route"].values()) == 0
        assert r["backward_calls"] == W["num_layers"]
    got = ranks[0]
    loss, grads = setup["one"]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    assert set(got["grads"]) == set(grads)
    _close_grads(got["grads"], grads, "one process")
    for label in ("jax", "jax_sp"):
        jax_loss, jax_grads = setup[label]
        np.testing.assert_allclose(got["loss"], jax_loss, rtol=LOSS_RTOL)
        _close_grads(got["grads"], jax_grads, label)
