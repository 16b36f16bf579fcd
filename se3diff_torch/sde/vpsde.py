"""Variance-preserving SDEs for the translation channel.

Counterpart of ``se3diff_tpu/sde/vpsde.py`` (`bioemu/src/bioemu/sde_lib.py:105-167`):
``dx = -1/2 beta(t) x dt + sqrt(beta(t)) dW`` with the cosine schedule
``alpha(t) = cos((t+s)/(1+s) * pi/2) / cos(s/(1+s) * pi/2)``, ``s = 0.008``.
"""

from __future__ import annotations

import abc
import math

import torch

from se3diff_torch.sde.base import SDE, bcast_right


class BaseVPSDE(SDE):
    """dx = -1/2 beta_t x dt + sqrt(beta_t) dW."""

    @abc.abstractmethod
    def beta(self, t: torch.Tensor) -> torch.Tensor: ...

    @abc.abstractmethod
    def _marginal_mean_coeff(self, t: torch.Tensor) -> torch.Tensor:
        """exp(-1/2 int_0^t beta(s) ds); eq. (29) of Song et al."""

    def marginal_prob(self, x, t):
        mean_coeff = bcast_right(self._marginal_mean_coeff(t), x)
        std = torch.sqrt(1.0 - mean_coeff.square()) * torch.ones_like(x)
        return mean_coeff * x, std

    def prior_sampling(self, generator, shape, *, dtype=torch.float32, device="cpu"):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)

    def sde(self, x, t):
        beta_t = bcast_right(self.beta(t), x)
        return -0.5 * beta_t * x, torch.sqrt(beta_t) * torch.ones_like(x)


class CosineVPSDE(BaseVPSDE):
    """VP SDE with the cosine noise schedule (sde_lib.py:153-167)."""

    def __init__(self, s: float = 0.008):
        self.s = s
        self.c = math.cos(s / (1 + s) * math.pi / 2)

    def beta(self, t):
        return torch.tan((t + self.s) / (1 + self.s) * math.pi / 2) * math.pi / (1 + self.s)

    def _marginal_mean_coeff(self, t):
        mean_coeff = torch.cos((t + self.s) / (1 + self.s) * math.pi / 2) / self.c
        # cos can dip below 0 at t ~ 1 in floating point; clamp to [0, 1].
        return mean_coeff.clamp(0.0, 1.0)
