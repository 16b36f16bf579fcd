"""Samplers of the PyTorch port against the JAX package's, from one prior.

The two packages draw different random numbers, so the JAX solver's own
prior (``_prior`` on the key it splits off) is fed to the port's solver
loop, and the final states are compared. The DPM solvers are deterministic
after the prior; the stochastic ones (``euler_maruyama``, ``heun``) are
also fed JAX's per-step standard normals, recovered by replaying its key
splits, through ``solve_from``'s ``draws``.

Models: the analytic closed-form score (tests/test_denoise.py) and a small
DiG carried over by ``state_dict_from_jax``. Tolerances: 1e-4 (analytic,
30 steps) and 5e-4 (DiG, 6 steps; positions also 1e-4 relative, since the
random weights drive them to ~100 nm) in f32: each step adds a few ulps of
difference, and the ODE carries them forward.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.diffusion import denoise as tden
from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.ops import so3 as tso3
from se3diff_torch.sde.base import bcast_right as tbcast
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchSO3
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchVP
from se3diff_tpu.diffusion import denoise as jden
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.sde.so3_sde import DiGSO3SDE as JaxSO3
from se3diff_tpu.sde.vpsde import CosineVPSDE as JaxVP
from tests.test_denoise import DATA_MEAN, DATA_STD, make_analytic_model

SO3 = dict(num_sigma=200, num_omega=1000, l_max=1000, eps_t=0.001)
SOLVERS = [("dpm_solver", "_dpm_solver_loop"), ("dpm_solver_pp2m", "_dpm_solver_pp2m_loop"),
           ("euler_maruyama", "_euler_maruyama_loop"), ("heun", "_heun_loop")]


@pytest.fixture(scope="module")
def sdes(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("so3"))
    return (
        jden.SDEs(pos=JaxVP(), node_orientations=JaxSO3(**SO3, cache_dir=cache)),
        tden.SDEs(pos=TorchVP(), node_orientations=TorchSO3(**SO3, cache_dir=cache, device="cpu")),
    )


def torch_analytic_model(sdes: tden.SDEs):
    """The closed-form model of tests/test_denoise.py, in torch."""

    def model_fn(pos, rot, t):
        alpha = tbcast(sdes.pos._marginal_mean_coeff(t), pos)
        var = alpha**2 * DATA_STD**2 + 1.0 - alpha**2
        pos_raw = -(pos - alpha * DATA_MEAN) / var * torch.sqrt(1.0 - alpha**2)
        score_rot = sdes.node_orientations.compute_score(
            tso3.rotmat_to_rotvec(rot), t, method="table"
        )
        scaling = tbcast(sdes.node_orientations.get_score_scaling(t), score_rot)
        return pos_raw, score_rot / scaling

    return model_fn


def _jax_run_and_prior(solver, key, sdes_j, model_fn, batch, length, steps):
    _, prior_key = jax.random.split(key)
    pos0, rot0 = jden._prior(prior_key, sdes_j, batch, length, jnp.float32)
    pos, rot = getattr(jden, solver)(key, sdes_j, model_fn, batch, length, num_steps=steps)
    return (np.array(pos0), np.array(rot0)), (np.asarray(pos, np.float32), np.asarray(rot, np.float32))


def _jax_draws(key, steps, batch, length):
    """Each step's ``(z_pos, z_rot)`` [T, B, L, 3], as the JAX samplers split
    their key (denoise.py:126-134, :222-224)."""
    key, _ = jax.random.split(key)
    zp, zr = [], []
    for _ in range(steps):
        key, k_pos, k_rot = jax.random.split(key, 3)
        zp.append(np.asarray(jax.random.normal(k_pos, (batch, length, 3), jnp.float32)))
        zr.append(np.asarray(jax.random.normal(k_rot, (batch, length, 3), jnp.float32)))
    return torch.from_numpy(np.stack(zp)), torch.from_numpy(np.stack(zr))


def _port_run(solver, loop, sdes_t, model_fn, pos0, rot0, steps, key):
    """The port's ``loop`` (through ``solve_from``) from JAX's prior, with
    JAX's per-step draws for the stochastic samplers."""
    assert tden._LOOPS[getattr(tden, solver)] is getattr(tden, loop)
    draws = _jax_draws(key, steps, *pos0.shape[:2]) if solver in ("euler_maruyama", "heun") else None
    return tden.solve_from(partial(getattr(tden, solver), num_steps=steps), sdes_t, model_fn,
                           torch.from_numpy(pos0), torch.from_numpy(rot0), draws)


@pytest.mark.parametrize("solver,loop", SOLVERS)
def test_solvers_match_with_analytic_model(sdes, solver, loop):
    sdes_j, sdes_t = sdes
    key = jax.random.key(0)
    (pos0, rot0), (pos_j, rot_j) = _jax_run_and_prior(
        solver, key, sdes_j, jax.jit(make_analytic_model(sdes_j)), 16, 4, 30
    )
    pos_t, rot_t = _port_run(solver, loop, sdes_t, torch_analytic_model(sdes_t), pos0, rot0, 30, key)
    np.testing.assert_allclose(pos_t.numpy(), pos_j, atol=1e-4)
    np.testing.assert_allclose(rot_t.numpy(), rot_j, atol=1e-4)


@pytest.mark.parametrize("solver,loop", SOLVERS)
def test_solvers_match_with_small_dig(sdes, solver, loop):
    sdes_j, sdes_t = sdes
    rng = np.random.default_rng(1)
    B, L, steps = 2, 8, 6
    cfg = dict(dim_model=64, dim_pair=32, num_layers=1, num_heads=4, dim_hidden=64)
    single = rng.standard_normal((B, L, 384)).astype(np.float32)
    pair = (rng.standard_normal((B, L, L, 128)) * 0.5).astype(np.float32)
    flax_model = FlaxDiG(**cfg, use_pallas=False)
    variables = jax.jit(flax_model.init)(
        jax.random.key(1), jnp.zeros((B, L, 3)), jnp.broadcast_to(jnp.eye(3), (B, L, 3, 3)),
        jnp.full((B,), 0.5), jnp.asarray(single), jnp.asarray(pair),
    )
    cache_j = flax_model.apply(
        variables, jnp.asarray(single), jnp.asarray(pair), method="embed_conditioning"
    )
    model_j = jax.jit(
        lambda p, r, t: flax_model.apply(variables, p, r, t, cache_j, method="score_from_cache")
    )
    key = jax.random.key(2)
    (pos0, rot0), (pos_j, rot_j) = _jax_run_and_prior(solver, key, sdes_j, model_j, B, L, steps)

    port = TorchDiG(**cfg).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        cache_t = port.embed_conditioning(torch.from_numpy(single), torch.from_numpy(pair))
        pos_t, rot_t = _port_run(solver, loop, sdes_t,
                                 lambda p, r, t: port.score_from_cache(p, r, t, cache_t),
                                 pos0, rot0, steps, key)
    np.testing.assert_allclose(pos_t.numpy(), pos_j, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(rot_t.numpy(), rot_j, atol=5e-4)


def test_public_solver_draws_its_prior_from_the_generator(sdes):
    _, sdes_t = sdes
    model = torch_analytic_model(sdes_t)
    runs = [
        tden.dpm_solver_pp2m(torch.Generator().manual_seed(5), sdes_t, model, 8, 3, num_steps=3)
        for _ in range(2)
    ]
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert runs[0][0].shape == (8, 3, 3) and runs[0][1].shape == (8, 3, 3, 3)
    with pytest.raises(ValueError):
        tden.dpm_solver(torch.Generator(), sdes_t, model, 2, 3, num_steps=0)
