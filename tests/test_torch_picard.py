"""``parallel_picard_em`` of the PyTorch port (``diffusion/denoise.py``)
against the port's sequential Euler–Maruyama and the JAX package's
``parallel_picard_em``, with the closed-form model of tests/test_denoise.py.

Tolerances are the JAX package's own (``TestParallelPicard``): positions
atol 5e-4, rotations within 5e-3 rad geodesic, f32. Sweep ``m`` reproduces
the sequential trajectory up to step ``m`` in exact arithmetic; the
rotation prefix products are bracketed differently from the sequential
chain and from ``lax.associative_scan``, which costs a few ulps a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.diffusion import denoise as tden
from se3diff_tpu.diffusion import denoise as jden
from tests.test_denoise import _check_moments
from tests.test_torch_denoise import _jax_draws, sdes, torch_analytic_model  # noqa: F401

POS_ATOL, ROT_RAD = 5e-4, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads here: the suite runs several workers on the
    same cores, and oversubscribed OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _geodesic(a, b) -> np.ndarray:
    rel = np.einsum("...ji,...jk->...ik", np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.arccos(np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0))


def test_prefix_products_equal_the_sequential_chain():
    g = torch.Generator().manual_seed(0)
    E = torch.linalg.matrix_exp(torch.randn(13, 2, 3, 3, generator=g, dtype=torch.float64) * 0.3)
    want, acc = [], torch.eye(3, dtype=torch.float64).expand(2, 3, 3)
    for k in range(13):
        acc = acc @ E[k]
        want.append(acc)
    torch.testing.assert_close(tden._prefix_products(E), torch.stack(want), rtol=0, atol=1e-12)


def test_full_sweeps_equal_sequential_euler_maruyama(sdes):  # noqa: F811
    _, sdes_t = sdes
    model = torch_analytic_model(sdes_t)
    N = 8
    pos_seq, rot_seq = tden.euler_maruyama(torch.Generator().manual_seed(11), sdes_t, model, 16, 3,
                                           num_steps=N)
    pos_par, rot_par = tden.parallel_picard_em(torch.Generator().manual_seed(11), sdes_t, model,
                                               16, 3, num_steps=N, num_sweeps=N)
    np.testing.assert_allclose(pos_par.numpy(), pos_seq.numpy(), atol=POS_ATOL)
    assert _geodesic(rot_seq.numpy(), rot_par.numpy()).max() < ROT_RAD


@pytest.mark.parametrize("sweeps", [3, 8])
def test_matches_jax_on_the_same_prior_and_draws(sdes, sweeps):  # noqa: F811
    sdes_j, sdes_t = sdes
    from tests.test_denoise import make_analytic_model

    key, B, L, N = jax.random.key(4), 16, 3, 8
    _, prior_key = jax.random.split(key)
    pos0, rot0 = jden._prior(prior_key, sdes_j, B, L, jnp.float32)
    pos_j, rot_j = jax.jit(lambda k: jden.parallel_picard_em(
        k, sdes_j, make_analytic_model(sdes_j), B, L, num_steps=N, num_sweeps=sweeps))(key)
    pos_t, rot_t = tden._parallel_picard_em_loop(
        sdes_t, torch_analytic_model(sdes_t), torch.from_numpy(np.array(pos0)),
        torch.from_numpy(np.array(rot0)), _jax_draws(key, N, B, L), N, sweeps, 0.99, 0.001, 1.0,
        1.0, torch.float32)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=POS_ATOL)
    assert _geodesic(np.asarray(rot_j), rot_t.numpy()).max() < ROT_RAD


def test_few_sweeps_recover_moments(sdes):  # noqa: F811
    """Early-stopped Picard still samples the target distribution."""
    _, sdes_t = sdes
    pos, rot = tden.parallel_picard_em(torch.Generator().manual_seed(4), sdes_t,
                                       torch_analytic_model(sdes_t), 256, 4, num_steps=64,
                                       num_sweeps=16)
    _check_moments(pos.numpy(), jnp.asarray(rot.numpy()))


def test_not_exported_and_refuses_no_steps(sdes):  # noqa: F811
    import se3diff_torch.diffusion as pkg

    assert not hasattr(pkg, "parallel_picard_em")
    with pytest.raises(ValueError, match="num_steps"):
        tden.parallel_picard_em(torch.Generator(), sdes[1], torch_analytic_model(sdes[1]), 1, 1,
                                num_steps=0)
