"""Euler–Maruyama predictor steps for Euclidean and SO(3) channels.

Counterpart of ``se3diff_tpu/diffusion/predictors.py`` (reference
`EulerMaruyamaPredictor`, `bioemu/src/bioemu/denoiser.py:30-166`), reduced to
the deterministic pieces the DPM solvers use: the reverse drift and the mean
update. The SO(3) update composes rotation-vector increments on the manifold;
the Euclidean update is additive.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.sde.base import SDE
from se3diff_torch.sde.so3_sde import SO3SDE


@dataclass(frozen=True)
class EulerMaruyamaPredictor:
    """Reverse-SDE integrator step (denoiser.py:30-131).

    Attributes:
        corruption: The forward SDE being reversed.
        noise_weight: 1.0 = Euler–Maruyama, 0.0 = probability-flow ODE.
        marginal_concentration_factor: Samples from ``p(x)^MCF``.
    """

    corruption: SDE
    noise_weight: float = 1.0
    marginal_concentration_factor: float = 1.0

    @property
    def _is_so3(self) -> bool:
        return isinstance(self.corruption, SO3SDE)

    def reverse_drift_and_diffusion(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        score: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``f - g^2 score w`` with ``w = MCF (1 + nw^2)/2``."""
        score_weight = 0.5 * self.marginal_concentration_factor * (1 + self.noise_weight**2)
        drift, diffusion = self.corruption.sde(x=x, t=t)
        return drift - diffusion**2 * score * score_weight, diffusion

    def mean_update(self, x: torch.Tensor, dt, drift: torch.Tensor) -> torch.Tensor:
        """Deterministic (diffusion=0) step, returning the mean only."""
        if self._is_so3:
            return so3_ops.apply_rotvec_to_rotmat(x, drift * dt, tol=self.corruption.tol)
        return x + drift * dt
