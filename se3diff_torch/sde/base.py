"""Abstract SDE interface for the corruption processes.

Counterpart of ``se3diff_tpu/sde/base.py`` (reference
`bioemu/src/bioemu/sde_lib.py:50-102`). Batches are dense ``[B, L, ...]``
tensors, so per-graph scalars broadcast with ordinary rules, and sampling
takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import abc

import torch


def bcast_right(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Append singleton axes to ``x`` so it broadcasts against ``like``
    (reference `_broadcast_like`, sde_lib.py:18-23)."""
    if x.ndim > like.ndim:
        raise ValueError(f"cannot broadcast {tuple(x.shape)} to {tuple(like.shape)}")
    return x.reshape(tuple(x.shape) + (1,) * (like.ndim - x.ndim))


class SDE(abc.ABC):
    """Corruption process defined by an SDE ``dx = f dt + g dW``."""

    @property
    def T(self) -> float:
        return 1.0

    @abc.abstractmethod
    def sde(self, x: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Drift ``f`` and diffusion coefficient ``g`` at ``(x, t)``."""

    @abc.abstractmethod
    def marginal_prob(
        self, x: torch.Tensor, t: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Mean and standard deviation of ``p_t(x(t) | x(0)=x)``."""

    def mean_coeff_and_std(
        self, x: torch.Tensor, t: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Marginal mean coefficient and std, both broadcast like ``x``."""
        return self.marginal_prob(torch.ones_like(x), t)

    @abc.abstractmethod
    def prior_sampling(
        self,
        generator: torch.Generator,
        shape: tuple[int, ...],
        *,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
    ) -> torch.Tensor:
        """Sample from the ``t=T`` prior."""

    def sample_marginal(
        self, generator: torch.Generator, x: torch.Tensor, t: torch.Tensor
    ) -> torch.Tensor:
        """Sample ``x(t) ~ p_t(. | x(0)=x)`` (Euclidean default: mean + std*z)."""
        mean, std = self.marginal_prob(x=x, t=t)
        z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return mean + std * z
