"""Host-side float64 generation of IGSO(3) lookup tables, plus an npz cache.

The reference builds its tables with a per-sigma Python loop over the series
expansion (`bioemu/src/bioemu/so3_sde.py:1943-2042`, flagged as the cold-start
hot spot in its init path). Here the whole ``[num_sigma x num_omega]`` table is
a single float64 matrix product over the ``l`` axis:

    f[s, o] = sum_l E[s, l] * S[l, o]        (then angle-dependent prefactors)

with ``E[s, l] = (2l+1) exp(-l(l+1) sigma_s^2 / 2)`` and
``S[l, o] = sin((l + 1/2) omega_o)``. This turns the reference's
minutes-long cold start into tens of milliseconds while producing the same
float64 numbers.

Tables are generated with numpy in float64 (independent of JAX's x64 flag) and
cached to npz files keyed by their generation parameters, mirroring the
reference cache layout (`so3_sde.py:914-990`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "igso3_table",
    "digso3_table",
    "dlog_igso3_table",
    "sampling_cdf_table",
    "uso3_cdf_table",
    "score_scaling_table",
    "omega_grid_cdf",
    "omega_grid_score",
    "cumulative_trapezoid",
    "SO3LookupCache",
    "SO3Tables",
    "build_so3_tables",
]


def _exp_term(sigma_grid: np.ndarray, l_grid: np.ndarray) -> np.ndarray:
    """``E[s, l] = exp(-l(l+1) sigma_s^2 / 2)`` in float64."""
    sigma = np.asarray(sigma_grid, dtype=np.float64)[:, None]
    l = np.asarray(l_grid, dtype=np.float64)[None, :]
    return np.exp(-l * (l + 1.0) * sigma**2 / 2.0)


def _scrub(x: np.ndarray) -> np.ndarray:
    x[~np.isfinite(x)] = 0.0
    return x


def igso3_table(
    omega_grid: np.ndarray,
    sigma_grid: np.ndarray,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> np.ndarray:
    """IGSO(3) angle density on a ``[num_sigma x num_omega]`` grid (float64).

    Matches `generate_igso3_lookup_table` (so3_sde.py:1986-2012) numerically,
    computed as one matmul instead of a per-sigma loop.
    """
    omega = np.asarray(omega_grid, dtype=np.float64)
    l_grid = np.arange(l_max + 1, dtype=np.float64)
    l_fac_1 = 2.0 * l_grid + 1.0

    e_term = _exp_term(sigma_grid, l_grid) * l_fac_1[None, :]  # [S, L]
    s_term = np.sin((l_grid[:, None] + 0.5) * omega[None, :])  # [L, O]

    f = e_term @ s_term  # [S, O]
    f /= np.sin(0.5 * omega)[None, :] + tol
    # Small-angle limit: sum_l (2l+1)^2 E[s, l].
    f_limw = e_term @ l_fac_1[:, None]  # [S, 1]
    f = np.where(omega[None, :] <= tol, f_limw, f)
    return np.clip(_scrub(f), 0.0, None)


def digso3_table(
    omega_grid: np.ndarray,
    sigma_grid: np.ndarray,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> np.ndarray:
    """d/d(omega) of :func:`igso3_table` on the same grid (float64).

    Matches `generate_dlog_igso3_lookup_table`'s inner derivative
    (so3_sde.py:1857-1913) via the closed-form
    ``[l sin((l+1)w) - (l+1) sin(l w)] / (1 - cos w)``.
    """
    omega = np.asarray(omega_grid, dtype=np.float64)
    l_grid = np.arange(l_max + 1, dtype=np.float64)
    l_fac_1 = 2.0 * l_grid + 1.0
    l_fac_2 = l_grid + 1.0

    e_term = _exp_term(sigma_grid, l_grid) * l_fac_1[None, :]  # [S, L]
    s_term = l_grid[:, None] * np.sin(l_fac_2[:, None] * omega[None, :]) - l_fac_2[
        :, None
    ] * np.sin(l_grid[:, None] * omega[None, :])  # [L, O]

    df = e_term @ s_term
    df /= (1.0 - np.cos(omega))[None, :] + tol
    df = np.where(omega[None, :] <= tol, 0.0, df)
    return _scrub(df)


def dlog_igso3_table(
    omega_grid: np.ndarray,
    sigma_grid: np.ndarray,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> np.ndarray:
    """d/d(omega) log f = f' / (f + tol) on the grid (float64)."""
    f = igso3_table(omega_grid, sigma_grid, l_max=l_max, tol=tol)
    df = digso3_table(omega_grid, sigma_grid, l_max=l_max, tol=tol)
    return df / (f + tol)


def cumulative_trapezoid(f_grid: np.ndarray, x_grid: np.ndarray) -> np.ndarray:
    """Cumulative trapezoid integral along the last axis (so3_sde.py:1475-1492)."""
    f_sum = f_grid[..., :-1] + f_grid[..., 1:]
    delta_x = np.diff(x_grid, axis=-1)
    return np.cumsum(f_sum * delta_x / 2.0, axis=-1)


def omega_grid_cdf(num_omega: int, omega_exponent: int = 3) -> np.ndarray:
    """Power-squashed angle grid with ``num_omega + 1`` points used for the CDF.

    ``linspace(0, 1, N+1)**p * pi`` — denser near zero (so3_sde.py:1165-1181).
    """
    grid = np.linspace(0.0, 1.0, num_omega + 1, dtype=np.float64)
    return grid**omega_exponent * np.pi


def omega_grid_score(num_omega: int, omega_exponent: int = 3) -> np.ndarray:
    """Angle grid with ``num_omega`` points used for score scaling (so3_sde.py:1670-1677)."""
    grid = np.linspace(0.0, 1.0, num_omega, dtype=np.float64)
    return grid**omega_exponent * np.pi


def sampling_cdf_table(
    sigma_grid: np.ndarray,
    num_omega: int,
    omega_exponent: int = 3,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse-transform sampling CDF for IGSO(3) angles.

    Returns ``(omega_grid[1:], cdf)`` with ``cdf`` of shape
    ``[num_sigma x num_omega]``, normalized to 1 at the right edge. The
    density includes the uniform-SO(3) prefactor ``(1 - cos w)/pi``
    (reference behavior: so3_sde.py:1131-1187).
    """
    omega = omega_grid_cdf(num_omega, omega_exponent)
    pdf = igso3_table(omega, sigma_grid, l_max=l_max, tol=tol)
    pdf = pdf * (1.0 - np.cos(omega))[None, :] / np.pi
    cdf = cumulative_trapezoid(pdf, omega)
    cdf = cdf / cdf[:, -1][:, None]
    return omega[1:], cdf


def uso3_cdf_table(
    num_omega: int, omega_exponent: int = 3
) -> tuple[np.ndarray, np.ndarray]:
    """CDF of the uniform SO(3) angle distribution on the squashed grid.

    The expansion is identically one; only the ``(1 - cos w)/pi`` prefactor
    remains (reference behavior: so3_sde.py:1455-1472).
    """
    omega = omega_grid_cdf(num_omega, omega_exponent)
    pdf = ((1.0 - np.cos(omega)) / np.pi)[None, :]
    cdf = cumulative_trapezoid(pdf, omega)
    cdf = cdf / cdf[:, -1][:, None]
    return omega[1:], cdf


def score_scaling_table(
    sigma_grid: np.ndarray,
    num_omega: int,
    omega_exponent: int = 3,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> np.ndarray:
    """Per-sigma score scaling ``lambda(sigma)`` used as loss weight.

    ``lambda = sqrt( sum_w (dlog f)^2 f / (3 sum_w f + tol) )`` over the
    squashed ``num_omega``-point grid, with the uniform-SO(3) prefactor
    applied to the density (reference behavior: so3_sde.py:1637-1696).
    """
    omega = omega_grid_score(num_omega, omega_exponent)
    pdf = igso3_table(omega, sigma_grid, l_max=l_max, tol=tol)
    pdf = np.abs(pdf * ((1.0 - np.cos(omega)) / np.pi)[None, :])
    dlog = dlog_igso3_table(omega, sigma_grid, l_max=l_max, tol=tol)
    return np.sqrt(np.sum(dlog**2 * pdf, axis=1) / (3.0 * np.sum(pdf, axis=1) + tol))


class SO3LookupCache:
    """npz-file cache for SO(3) lookup tables, keyed by generation parameters.

    File naming mirrors the reference
    (``cache_{type}_s{smin}-{smax}-{num}_l{l}_o{omega}-{exp}.npz``,
    so3_sde.py:1090-1099) so caches are recognizable across tools.
    """

    def __init__(self, cache_dir: str, cache_file: str, overwrite: bool = False):
        if not cache_file.endswith(".npz"):
            raise ValueError("Filename should have '.npz' extension.")
        self.cache_dir = os.path.expanduser(cache_dir)
        self.cache_file = cache_file
        self.overwrite = overwrite

    @property
    def path(self) -> str:
        return os.path.join(self.cache_dir, self.cache_file)

    @property
    def path_exists(self) -> bool:
        return os.path.exists(self.path)

    def load_cache(self) -> dict[str, np.ndarray]:
        with np.load(self.path) as data:
            return {k: np.asarray(data[k]) for k in data.files}

    def save_cache(self, data: dict[str, np.ndarray]) -> None:
        # Written under a private name and renamed, so a process that builds
        # the same tables at the same time never reads a partial file.
        os.makedirs(self.cache_dir, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **data)
        os.replace(tmp, self.path)


def _cache_name(
    so3_type: str,
    sigma_grid: np.ndarray,
    num_omega: int,
    omega_exponent: int,
    l_max: int | None = None,
) -> str:
    smin, smax, num = float(sigma_grid.min()), float(sigma_grid.max()), len(sigma_grid)
    l_part = f"_l{l_max:d}" if l_max is not None else ""
    return (
        f"cache_{so3_type}_s{smin:04.3f}-{smax:04.3f}-{num:d}"
        f"{l_part}_o{num_omega:d}-{omega_exponent:d}.npz"
    )


@dataclass(frozen=True)
class SO3Tables:
    """All precomputed SO(3) diffusion tables, as float64 numpy arrays.

    Consumed by ``se3diff_torch.sde.so3_sde.SO3SDE`` which casts them to device
    arrays in the working dtype.
    """

    sigma_grid: np.ndarray  # [S]
    omega_grid: np.ndarray  # [O]  (CDF grid, first point dropped)
    cdf_igso3: np.ndarray  # [S, O]
    cdf_uso3: np.ndarray  # [1, O]
    score_scaling: np.ndarray  # [S]
    # Dense dlog table for fast interpolated score evaluation (our addition;
    # the reference re-evaluates the series at runtime).
    score_omega_grid: np.ndarray  # [O]
    dlog_igso3: np.ndarray  # [S, O]


def build_so3_tables(
    sigma_grid: np.ndarray,
    num_omega: int,
    omega_exponent: int = 3,
    l_max: int = 1000,
    tol: float = 1e-7,
    cache_dir: str | None = None,
    overwrite_cache: bool = False,
) -> SO3Tables:
    """Build (or load from cache) every table the SO(3) SDE needs."""
    sigma_grid = np.asarray(sigma_grid, dtype=np.float64)

    def _cached(so3_type: str, l_arg: int | None, build):
        if cache_dir is None:
            return build()
        cache = SO3LookupCache(
            cache_dir, _cache_name(so3_type, sigma_grid, num_omega, omega_exponent, l_arg)
        )
        if cache.path_exists and not overwrite_cache:
            return cache.load_cache()
        data = build()
        cache.save_cache(data)
        return data

    igso3_data = _cached(
        "igso3",
        l_max,
        lambda: dict(
            zip(
                ("omega_grid", "cdf_igso3"),
                sampling_cdf_table(sigma_grid, num_omega, omega_exponent, l_max, tol),
            )
        ),
    )
    uso3_data = _cached(
        "uso3",
        None,
        lambda: dict(zip(("omega_grid", "cdf_igso3"), uso3_cdf_table(num_omega, omega_exponent))),
    )
    scaling_data = _cached(
        "score-scaling",
        l_max + 1,
        lambda: {
            "score_scaling": score_scaling_table(
                sigma_grid, num_omega, omega_exponent, l_max, tol
            )
        },
    )
    score_omega = omega_grid_score(num_omega, omega_exponent)
    dlog_data = _cached(
        "dlog",
        l_max,
        lambda: {"dlog_igso3": dlog_igso3_table(score_omega, sigma_grid, l_max=l_max, tol=tol)},
    )

    return SO3Tables(
        sigma_grid=sigma_grid,
        omega_grid=igso3_data["omega_grid"],
        cdf_igso3=igso3_data["cdf_igso3"],
        cdf_uso3=uso3_data["cdf_igso3"],
        score_scaling=scaling_data["score_scaling"],
        score_omega_grid=score_omega,
        dlog_igso3=dlog_data["dlog_igso3"],
    )
