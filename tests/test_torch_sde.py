"""IGSO(3) expansions, SDE schedules and table caches: port vs JAX package.

Inputs are numpy arrays from a seeded generator, handed to both packages.
The expansions are compared in float64 at 1e-6 relative to the series'
scale, the tolerance of ``tests/test_golden_so3.py``. The schedules are
float32 on both sides (the SDE tables' working dtype) and held at 1e-6:
the same formulas, with the libraries' elementwise kernels differing by a
few ulps. Small tables (l_max=200) are used only at t >= 0.05, where the
truncated series converges (sigma(t) * l_max >> 3).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import igso3 as tigso3
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchDiGSO3SDE
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchCosineVPSDE
from se3diff_tpu.ops import igso3 as jigso3
from se3diff_tpu.sde.so3_sde import DiGSO3SDE as JaxDiGSO3SDE
from se3diff_tpu.sde.vpsde import CosineVPSDE as JaxCosineVPSDE

SMALL = dict(num_sigma=50, num_omega=200, l_max=200, sigma_max=2.33)


@pytest.mark.parametrize(
    "name", ["igso3_expansion", "digso3_expansion", "dlog_igso3_expansion"]
)
def test_igso3_expansions_match(rng, name):
    omega = np.concatenate([[0.0, 1e-8], rng.uniform(0.0, np.pi, 62)])
    sigma = rng.uniform(0.05, 2.33, 64)
    orders = np.arange(301, dtype=np.float64)
    want = np.asarray(getattr(jigso3, name)(jnp.asarray(omega), jnp.asarray(sigma), jnp.asarray(orders)))
    got = getattr(tigso3, name)(torch.tensor(omega), torch.tensor(sigma), torch.tensor(orders))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_marginal_pdf_and_uniform_density_match(rng):
    omega = rng.uniform(0.0, np.pi, 32)
    omega_0 = np.concatenate([[0.0], rng.uniform(0.0, np.pi, 31)])
    sigma = rng.uniform(0.1, 2.0, 32)
    orders = np.arange(201, dtype=np.float64)
    want = np.asarray(jigso3.igso3_marginal_pdf(*map(jnp.asarray, (omega, omega_0, sigma, orders))))
    got = tigso3.igso3_marginal_pdf(*map(torch.tensor, (omega, omega_0, sigma, orders)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(
        tigso3.uniform_so3_density(torch.tensor(omega)).numpy(),
        np.asarray(jigso3.uniform_so3_density(jnp.asarray(omega))), rtol=1e-12,
    )


@pytest.fixture(scope="module")
def so3_pair(tmp_path_factory):
    cache = tmp_path_factory.mktemp("so3_cache")
    return (
        JaxDiGSO3SDE(**SMALL, cache_dir=str(cache)),
        TorchDiGSO3SDE(**SMALL, cache_dir=str(cache), device="cpu"),
        cache,
    )


def test_one_table_cache_serves_both_packages(so3_pair):
    jax_sde, torch_sde, cache = so3_pair
    files = sorted(p.name for p in Path(cache).glob("*.npz"))
    assert len(files) == 4, files
    # The port read the JAX package's files: same tables, bit for bit.
    for attr in ("sigma_grid", "omega_grid", "cdf_igso3", "cdf_uso3",
                 "score_scaling_table", "dlog_table"):
        np.testing.assert_array_equal(
            getattr(torch_sde, attr).numpy(), np.asarray(getattr(jax_sde, attr)), err_msg=attr
        )
    mtimes = {p.name: p.stat().st_mtime_ns for p in Path(cache).glob("*.npz")}
    TorchDiGSO3SDE(**SMALL, cache_dir=str(cache), device="cpu")
    assert mtimes == {p.name: p.stat().st_mtime_ns for p in Path(cache).glob("*.npz")}


def test_so3_schedule_and_scaling_match(so3_pair):
    jax_sde, torch_sde, _ = so3_pair
    t = np.linspace(0.05, 1.0, 41).astype(np.float32)
    tj, tt = jnp.asarray(t), torch.from_numpy(t)
    for fn in ("_marginal_std", "beta", "get_score_scaling"):
        np.testing.assert_allclose(
            getattr(torch_sde, fn)(tt).numpy(), np.asarray(getattr(jax_sde, fn)(tj)),
            rtol=1e-6, err_msg=fn,
        )
    x = np.broadcast_to(np.eye(3, dtype=np.float32), (41, 5, 3, 3)).copy()
    for a, b in zip(torch_sde.mean_coeff_and_std(torch.from_numpy(x), tt),
                    jax_sde.mean_coeff_and_std(jnp.asarray(x), tj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("method", ["series", "table"])
def test_so3_score_matches(so3_pair, rng, method):
    jax_sde, torch_sde, _ = so3_pair
    # Rotation vectors at the scale of the marginal, sigma(t): far in the
    # tail the f32 density underflows and f'/f is noise in both packages.
    t = rng.uniform(0.05, 1.0, 16).astype(np.float32)
    sigma = np.asarray(jax_sde._marginal_std(t))[:, None, None]
    q = (rng.standard_normal((16, 8, 3)) * sigma).astype(np.float32)
    want = np.asarray(jax_sde.compute_score(jnp.asarray(q), jnp.asarray(t), method=method))
    got = torch_sde.compute_score(torch.from_numpy(q), torch.from_numpy(t), method=method)
    # 1e-4 of the scores' scale: the f32 series sums 201 terms in another
    # order, and f'/f divides two such sums.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_vpsde_schedule_matches(rng):
    jsde, tsde = JaxCosineVPSDE(), TorchCosineVPSDE()
    t = np.concatenate([[0.0, 0.001, 0.99, 1.0], rng.uniform(0, 1, 28)]).astype(np.float32)
    x = rng.standard_normal((32, 6, 3)).astype(np.float32)
    for fn in ("marginal_prob", "mean_coeff_and_std", "sde"):
        got = getattr(tsde, fn)(torch.from_numpy(x), torch.from_numpy(t))
        want = getattr(jsde, fn)(jnp.asarray(x), jnp.asarray(t))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=fn)


def test_prior_draws_are_uniform_rotations(so3_pair):
    """The generators differ, so the prior is held by its distribution: the
    angle of a Haar-uniform rotation has mean pi/2 + 2/pi (about 2.21)."""
    _, torch_sde, _ = so3_pair
    R = torch_sde.prior_sampling(torch.Generator().manual_seed(0), (4096, 3, 3))
    angles = torch.arccos(((torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1))
    assert abs(angles.mean().item() - (np.pi / 2 + 2 / np.pi)) < 0.05


def _angles(R):
    return np.arccos(np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1))


def test_sample_marginal_matches_in_distribution(so3_pair, rng):
    """The generators differ, so the marginal draws are held by their
    moments over 4096 draws each. Tolerances are four to six standard
    errors: 0.015 rad for the difference of the mean IGSO(3) angles (their
    spread is 0.16 rad at t=0.5), 0.04 for the mean and std of the VP
    draws' standardised noise (12,288 values each)."""
    jax_sde, torch_sde, _ = so3_pair
    n = 4096
    x = np.array(jax_sde.prior_sampling(jax.random.PRNGKey(1), (n, 3, 3)), np.float32)
    t = np.full((n,), 0.5, np.float32)
    got = torch_sde.sample_marginal(
        torch.Generator().manual_seed(0), torch.from_numpy(x), torch.from_numpy(t)
    ).numpy()
    want = np.asarray(jax_sde.sample_marginal(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t)))
    rel = np.swapaxes(x, -1, -2) @ got
    np.testing.assert_allclose(rel @ np.swapaxes(rel, -1, -2), np.broadcast_to(np.eye(3), rel.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(rel), 1.0, atol=1e-5)
    rel_j = np.swapaxes(x, -1, -2) @ want
    assert abs(_angles(rel).mean() - _angles(rel_j).mean()) < 0.015

    jsde, tsde = JaxCosineVPSDE(), TorchCosineVPSDE()
    xv = rng.standard_normal((n, 3)).astype(np.float32)
    tv = rng.uniform(0.05, 0.95, n).astype(np.float32)
    mean, std = (np.asarray(a) for a in jsde.marginal_prob(jnp.asarray(xv), jnp.asarray(tv)))
    z_t = (tsde.sample_marginal(torch.Generator().manual_seed(0), torch.from_numpy(xv),
                                torch.from_numpy(tv)).numpy() - mean) / std
    z_j = (np.asarray(jsde.sample_marginal(jax.random.PRNGKey(0), jnp.asarray(xv), jnp.asarray(tv))) - mean) / std
    for z in (z_t, z_j):
        assert abs(z.mean()) < 0.04 and abs(z.std() - 1.0) < 0.04
