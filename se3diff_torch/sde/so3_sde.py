"""SO(3) diffusion SDE with table-backed IGSO(3) sampling and scores.

Counterpart of ``se3diff_tpu/sde/so3_sde.py`` (`bioemu/src/bioemu/so3_sde.py:20-403`
plus the sampler/score modules at `:993-1715`). Lookup tables are built on the
host in float64 (``ops.tables``) and held as tensors in the working dtype on
the SDE's device; inverse-CDF sampling is a vectorised gather + lerp, and
every sampling method takes a ``torch.Generator`` on that device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from se3diff_torch.ops import igso3 as igso3_ops
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.ops.tables import SO3Tables, build_so3_tables
from se3diff_torch.sde.base import SDE, bcast_right

_TABLE_FIELDS = (
    "sigma_grid", "omega_grid", "cdf_igso3", "cdf_uso3",
    "score_scaling_table", "score_omega_grid", "dlog_table", "l_grid",
)


class SO3SDE(SDE):
    """Driftless SO(3) SDE ``dR = g(t) dB_SO(3)`` with IGSO(3) marginals.

    Subclasses implement ``beta`` and ``_marginal_std`` with operators shared
    by numpy and torch, so the same code builds float64 tables and runs on
    tensors.
    """

    def __init__(
        self,
        eps_t: float = 1e-4,
        num_sigma: int = 1000,
        num_omega: int = 1000,
        omega_exponent: int = 3,
        l_max: int = 1000,
        tol: float = 1e-7,
        cache_dir: str | None = None,
        overwrite_cache: bool = False,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
    ):
        self.tol = tol
        self.l_max = l_max
        self.dtype = dtype
        self.eps_t = eps_t

        sigma_grid = np.asarray(
            self._marginal_std(np.linspace(eps_t, self.T, num_sigma, dtype=np.float64))
        )
        tables: SO3Tables = build_so3_tables(
            sigma_grid,
            num_omega=num_omega,
            omega_exponent=omega_exponent,
            l_max=l_max,
            tol=tol,
            cache_dir=cache_dir,
            overwrite_cache=overwrite_cache,
        )
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
        self.sigma_grid = as_t(tables.sigma_grid)
        self.omega_grid = as_t(tables.omega_grid)
        self.cdf_igso3 = as_t(tables.cdf_igso3)
        self.cdf_uso3 = as_t(tables.cdf_uso3)
        self.score_scaling_table = as_t(tables.score_scaling)
        self.score_omega_grid = as_t(tables.score_omega_grid)
        self.dlog_table = as_t(tables.dlog_igso3)
        self.l_grid = torch.arange(l_max + 1, dtype=dtype)
        self.to(device)

    def to(self, device: torch.device | str) -> "SO3SDE":
        """Move every table to ``device`` (in place); returns ``self``."""
        for name in _TABLE_FIELDS:
            setattr(self, name, getattr(self, name).to(device))
        return self

    @property
    def device(self) -> torch.device:
        return self.sigma_grid.device

    # ------------------------------------------------------------------ #
    # schedule (abstract)                                                #
    # ------------------------------------------------------------------ #

    def beta(self, t):
        raise NotImplementedError

    def _marginal_std(self, t):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # SDE interface                                                      #
    # ------------------------------------------------------------------ #

    def sde(self, x, t):
        """Drift (zero) and diffusion in rotation-vector form ``[..., 3]``
        for rotation matrices ``x [..., 3, 3]`` (so3_sde.py:172-196)."""
        drift = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        diffusion = bcast_right(self.beta(t), drift) * torch.ones_like(drift)
        return drift, diffusion

    def marginal_prob(self, x, t):
        """Variance-exploding marginal: the mean is ``x`` (so3_sde.py:380-403)."""
        return x, self._marginal_std(t)

    def mean_coeff_and_std(self, x, t):
        mean = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
        std = bcast_right(self._marginal_std(t), mean) * torch.ones_like(mean)
        return mean, std

    # ------------------------------------------------------------------ #
    # sampling                                                           #
    # ------------------------------------------------------------------ #

    def _sample_angles(
        self, generator: torch.Generator, cdf_rows: torch.Tensor, shape: tuple[int, ...]
    ) -> torch.Tensor:
        p_uniform = torch.rand(
            shape, generator=generator, dtype=cdf_rows.dtype, device=cdf_rows.device
        )
        return self._angles_from_uniform(cdf_rows, p_uniform)

    def _angles_from_uniform(self, cdf_rows: torch.Tensor, p_uniform: torch.Tensor) -> torch.Tensor:
        """Inverse-transform sampling from per-element CDF rows
        ``shape + [num_omega]`` at uniforms ``shape`` (so3_sde.py:1244-1286)."""
        idx_stop = (cdf_rows < p_uniform[..., None]).sum(-1)
        idx_stop = idx_stop.clamp(0, cdf_rows.shape[-1] - 1)
        idx_start = (idx_stop - 1).clamp(min=0)

        cdf_start = torch.take_along_dim(cdf_rows, idx_start[..., None], dim=-1)[..., 0]
        cdf_stop = torch.take_along_dim(cdf_rows, idx_stop[..., None], dim=-1)[..., 0]
        cdf_delta = (cdf_stop - cdf_start).clamp(min=self.tol)
        weight = ((p_uniform - cdf_start) / cdf_delta).clamp(0.0, 1.0)

        omega_start = self.omega_grid[idx_start]
        omega_stop = self.omega_grid[idx_stop]
        return omega_start + weight * (omega_stop - omega_start)

    def _random_axes(self, generator: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
        axes = torch.randn((*shape, 3), generator=generator, dtype=self.dtype, device=self.device)
        return axes / (torch.linalg.vector_norm(axes, dim=-1, keepdim=True) + self.tol)

    def get_sigma_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        """Index of the closest tabulated sigma (``torch.bucketize`` semantics)."""
        idx = torch.searchsorted(self.sigma_grid, sigma.contiguous(), side="left")
        return idx.clamp(0, self.sigma_grid.shape[0] - 1)

    def sample_igso3(self, generator: torch.Generator, sigma: torch.Tensor) -> torch.Tensor:
        """One IGSO(3)(I, sigma) rotation matrix per element of ``sigma``;
        angles forced to zero for ``sigma < tol`` (so3_sde.py:1289-1391)."""
        shape = tuple(sigma.shape)
        axes = torch.randn((*shape, 3), generator=generator, dtype=self.dtype, device=self.device)
        p_uniform = torch.rand(shape, generator=generator, dtype=self.dtype, device=self.device)
        return self.igso3_from_draws(sigma, axes, p_uniform)

    def igso3_from_draws(
        self, sigma: torch.Tensor, axes: torch.Tensor, p_uniform: torch.Tensor
    ) -> torch.Tensor:
        """:meth:`sample_igso3` on given draws: standard normals ``axes
        [..., 3]`` (normalised to the rotation axis) and uniforms ``p_uniform``
        (the angle's inverse-CDF argument), both shaped like ``sigma``."""
        axes = axes / (torch.linalg.vector_norm(axes, dim=-1, keepdim=True) + self.tol)
        angles = self._angles_from_uniform(self.cdf_igso3[self.get_sigma_idx(sigma)], p_uniform)
        angles = torch.where(sigma < self.tol, torch.zeros_like(angles), angles)
        return so3_ops.rotvec_to_rotmat(axes * angles[..., None], tol=self.tol)

    def sample_uso3(self, generator: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
        """Haar-uniform rotation matrices via the tabulated USO(3) CDF."""
        axes = self._random_axes(generator, shape)
        cdf_rows = self.cdf_uso3[0].expand(*shape, self.cdf_uso3.shape[-1])
        angles = self._sample_angles(generator, cdf_rows, shape)
        return so3_ops.rotvec_to_rotmat(axes * angles[..., None], tol=self.tol)

    def prior_sampling(self, generator, shape, *, dtype=torch.float32, device=None):
        """Uniform SO(3) prior. ``shape`` must end in (3, 3); tables fix the
        dtype and device of the draw."""
        if tuple(shape[-2:]) != (3, 3):
            raise ValueError(f"prior shape must end in (3, 3), got {shape}")
        return self.sample_uso3(generator, tuple(shape[:-2])).to(dtype)

    def sample_marginal(self, generator, x, t):
        """IGSO3(x, sigma(t)) = x @ IGSO3(I, sigma(t)) (so3_sde.py:249-288)."""
        std = self._marginal_std(t)
        std = bcast_right(std, torch.empty(x.shape[:-2])).expand(x.shape[:-2])
        return x @ self.sample_igso3(generator, std)

    # ------------------------------------------------------------------ #
    # score                                                              #
    # ------------------------------------------------------------------ #

    def compute_score(
        self, rotation_vectors: torch.Tensor, t: torch.Tensor, method: str = "series"
    ) -> torch.Tensor:
        """Score ``q/|q| * d/dw log f(|q|; sigma(t))`` in vector form.

        ``method='series'`` re-sums the truncated expansion like the reference
        runtime (so3_sde.py:1698-1715); ``method='table'`` interpolates the
        precomputed dlog table, which is only meaningful where the truncated
        series converges (``l_max * sigma_min >> 3``).
        """
        batch_shape = rotation_vectors.shape[:-1]
        sigma = bcast_right(self._marginal_std(t), torch.empty(batch_shape)).expand(batch_shape)
        angles = torch.linalg.vector_norm(rotation_vectors, dim=-1)
        if method == "series":
            dlog = igso3_ops.dlog_igso3_expansion(angles, sigma, self.l_grid, tol=self.tol)
        elif method == "table":
            dlog = self._dlog_from_table(angles, sigma)
        else:
            raise ValueError(f"unknown score method {method!r}")
        return rotation_vectors / (angles[..., None] + self.tol) * dlog[..., None]

    def _dlog_from_table(self, angles: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """Linear interpolation along omega, nearest tabulated sigma."""
        rows = self.dlog_table[self.get_sigma_idx(sigma)]  # [..., O]
        grid = self.score_omega_grid
        idx_hi = torch.searchsorted(grid, angles.contiguous(), side="left")
        idx_hi = idx_hi.clamp(1, grid.shape[0] - 1)
        idx_lo = idx_hi - 1
        w_lo, w_hi = grid[idx_lo], grid[idx_hi]
        frac = ((angles - w_lo) / (w_hi - w_lo + self.tol)).clamp(0.0, 1.0)
        v_lo = torch.take_along_dim(rows, idx_lo[..., None], dim=-1)[..., 0]
        v_hi = torch.take_along_dim(rows, idx_hi[..., None], dim=-1)[..., 0]
        return v_lo + frac * (v_hi - v_lo)

    def get_score_scaling(self, t: torch.Tensor) -> torch.Tensor:
        """Tabulated scaling ``lambda(sigma(t))`` (no gradients)."""
        sigma = self._marginal_std(t)
        return self.score_scaling_table[self.get_sigma_idx(sigma)].detach()


class DiGSO3SDE(SO3SDE):
    """Variance-exploding SO(3) SDE with DiG's geometric sigma schedule.

    ``sigma(t) = sigma_min (sigma_max/sigma_min)^t`` and
    ``g(t) = sigma(t) sqrt(2 log(sigma_max/sigma_min))`` (so3_sde.py:291-403).
    """

    def __init__(
        self,
        eps_t: float = 1e-4,
        num_sigma: int = 1000,
        num_omega: int = 2000,
        omega_exponent: int = 3,
        l_max: int = 2000,
        sigma_min: float = 0.02,
        sigma_max: float = 1.65,
        tol: float = 1e-7,
        cache_dir: str | None = None,
        overwrite_cache: bool = False,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
    ):
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        super().__init__(
            eps_t=eps_t,
            num_sigma=num_sigma,
            num_omega=num_omega,
            omega_exponent=omega_exponent,
            l_max=l_max,
            tol=tol,
            cache_dir=cache_dir,
            overwrite_cache=overwrite_cache,
            dtype=dtype,
            device=device,
        )

    def beta(self, t):
        return self._marginal_std(t) * math.sqrt(2.0 * math.log(self.sigma_max / self.sigma_min))

    def _marginal_std(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t
