"""Euler–Maruyama predictor steps for Euclidean and SO(3) channels.

Counterpart of ``se3diff_tpu/diffusion/predictors.py`` (reference
`EulerMaruyamaPredictor`, `bioemu/src/bioemu/denoiser.py:30-166`): the
reverse drift, the mean update, the stochastic step, the forward (noising)
step of Heun's churn and the Brownian-increment traceback. The SO(3) update
composes rotation-vector increments on the manifold; the Euclidean update is
additive.

A stochastic step takes its noise as ``noise``: a ``torch.Generator`` to draw
the standard normal ``z`` from, ``z`` itself (what the tests use to feed
the JAX package's draws), or a callable ``like -> z`` (data-parallel
sampling draws the whole batch's ``z`` and keeps its own rows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.sde.base import SDE
from se3diff_torch.sde.so3_sde import SO3SDE

Noise = torch.Generator | torch.Tensor | Callable[[torch.Tensor], torch.Tensor]


def standard_normal(noise: Noise, like: torch.Tensor) -> torch.Tensor:
    """``z`` shaped like ``like``: drawn from the generator ``noise``,
    ``noise`` itself when it is a tensor, or ``noise(like)``."""
    if callable(noise):
        noise = noise(like)
    if isinstance(noise, torch.Tensor):
        if noise.shape != like.shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {tuple(like.shape)}")
        return noise.to(like)
    return torch.randn(like.shape, generator=noise, dtype=like.dtype, device=like.device)


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
        finetune_score: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``f - g^2 score w  (+ g u w)`` with ``w = MCF (1 + nw^2)/2``."""
        score_weight = 0.5 * self.marginal_concentration_factor * (1 + self.noise_weight**2)
        drift, diffusion = self.corruption.sde(x=x, t=t)
        drift = drift - diffusion**2 * score * score_weight
        if finetune_score is not None:
            drift = drift + diffusion * finetune_score * score_weight
        return drift, diffusion

    def update_given_drift_and_diffusion(
        self, noise: Noise, x: torch.Tensor, dt, drift: torch.Tensor, diffusion: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One integrator step; returns ``(sample, mean, dW)``.

        SO(3): ``mean = x exp(drift dt)``, ``sample = mean exp(g dW)``
        (denoiser.py:72-97). Euclidean: additive. ``dt`` is a Python float.
        """
        dW = self.noise_weight * abs(dt) ** 0.5 * standard_normal(noise, drift)
        if self._is_so3:
            tol = self.corruption.tol
            mean = so3_ops.apply_rotvec_to_rotmat(x, drift * dt, tol=tol)
            sample = so3_ops.apply_rotvec_to_rotmat(mean, diffusion * dW, tol=tol)
        else:
            mean = x + drift * dt
            sample = mean + diffusion * dW
        return sample, mean, dW

    def update_given_score(
        self,
        noise: Noise,
        x: torch.Tensor,
        t: torch.Tensor,
        dt,
        score: torch.Tensor,
        finetune_score: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        drift, diffusion = self.reverse_drift_and_diffusion(x, t, score, finetune_score)
        return self.update_given_drift_and_diffusion(noise, x, dt, drift, diffusion)

    def forward_sde_step(
        self, noise: Noise, x: torch.Tensor, t: torch.Tensor, dt
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Forward (noising) step of Heun's churn (denoiser.py:118-131)."""
        drift, diffusion = self.corruption.sde(x=x, t=t)
        return self.update_given_drift_and_diffusion(noise, x, dt, drift, diffusion)

    def mean_update(self, x: torch.Tensor, dt, drift: torch.Tensor) -> torch.Tensor:
        """Deterministic (diffusion=0) step, returning the mean only."""
        if self._is_so3:
            return so3_ops.apply_rotvec_to_rotmat(x, drift * dt, tol=self.corruption.tol)
        return x + drift * dt

    def traceback_brownian_motion(
        self,
        x_next: torch.Tensor,
        x: torch.Tensor,
        t: torch.Tensor,
        dt,
        score: torch.Tensor,
        finetune_score: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The Brownian increment that maps ``x`` to ``x_next`` under an EM
        step, for the Heun finetune path whose update is not one
        (denoiser.py:133-166)."""
        drift, diffusion = self.reverse_drift_and_diffusion(x, t, score, finetune_score)
        mean = self.mean_update(x, dt, drift)
        if self._is_so3:
            rel = torch.einsum("...ji,...jk->...ik", mean, x_next)
            return so3_ops.rotmat_to_rotvec(rel) / diffusion
        return (x_next - mean) / diffusion
