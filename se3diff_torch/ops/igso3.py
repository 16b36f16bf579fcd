"""IGSO(3) series-expansion densities as batched PyTorch tensor functions.

Counterpart of ``se3diff_tpu/ops/igso3.py`` (reference series expansions,
`bioemu/src/bioemu/so3_sde.py:1731-1940`). The isotropic Gaussian on SO(3)
at scale ``sigma`` has angle density (up to the Haar prefactor)

    f(omega; sigma) = sum_l (2l+1) exp(-l(l+1) sigma^2 / 2) chi_l(omega),

with ``chi_l(omega) = sin((l+1/2) omega) / sin(omega/2)``. All functions
broadcast ``omega`` and ``sigma`` and reduce over the trailing ``orders`` axis.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "igso3_expansion",
    "igso3_marginal_pdf",
    "digso3_expansion",
    "dlog_igso3_expansion",
    "uniform_so3_density",
]


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    """Zero out inf/nan artifacts of the truncated series."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _heat_weights(sigma: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """``exp(-l(l+1) sigma^2 / 2)``, one per order along a new trailing axis."""
    return torch.exp(0.5 * (-orders * (orders + 1.0)) * sigma[..., None].square())


def igso3_expansion(
    omega: torch.Tensor, sigma: torch.Tensor, orders: torch.Tensor, tol: float = 1e-7
) -> torch.Tensor:
    """Truncated IGSO(3) angle density without the uniform-SO(3) prefactor.

    For ``omega <= tol`` the analytic limit ``sum_l (2l+1)^2 w_l`` is used
    (so3_sde.py:1731-1792).
    """
    omega, sigma = torch.broadcast_tensors(omega, sigma)
    multiplicity = 2.0 * orders + 1.0
    weighted = multiplicity * _heat_weights(sigma, orders)
    series = (weighted * torch.sin((orders + 0.5) * omega[..., None])).sum(-1)
    density = series / (torch.sin(0.5 * omega) + tol)
    at_zero = (weighted * multiplicity).sum(-1)
    density = torch.where(omega <= tol, at_zero, density)
    return _finite_or_zero(density).clamp(min=0.0)


def igso3_marginal_pdf(
    omega: torch.Tensor,
    omega_0: torch.Tensor,
    sigma: torch.Tensor,
    orders: torch.Tensor,
    tol: float = 1e-7,
) -> torch.Tensor:
    """Marginal pdf of the angle between an IGSO(3) sample and a fixed
    rotation at angle ``omega_0`` from the mean (so3_sde.py:1795-1854)."""
    omega, omega_0, sigma = torch.broadcast_tensors(omega, omega_0, sigma)
    weights = _heat_weights(sigma, orders)
    half_angles = (orders + 0.5) * omega[..., None]
    series = (
        weights * torch.sin(half_angles) * torch.sin((orders + 0.5) * omega_0[..., None])
    ).sum(-1)
    pdf = series * torch.sin(0.5 * omega) / (torch.sin(0.5 * omega_0) + tol)
    at_zero = (weights * (2.0 * orders + 1.0) * torch.sin(half_angles)).sum(-1)
    pdf = torch.where(omega_0 <= tol, at_zero * torch.sin(0.5 * omega), pdf)
    return (_finite_or_zero(pdf) * (2.0 / math.pi)).clamp(min=0.0)


def digso3_expansion(
    omega: torch.Tensor, sigma: torch.Tensor, orders: torch.Tensor, tol: float = 1e-7
) -> torch.Tensor:
    """Analytic d/d(omega) of :func:`igso3_expansion` via
    ``chi_l' = [l sin((l+1) w) - (l+1) sin(l w)] / (1 - cos w)``
    (so3_sde.py:1857-1913)."""
    omega, sigma = torch.broadcast_tensors(omega, sigma)
    weighted = (2.0 * orders + 1.0) * _heat_weights(sigma, orders)
    w = omega[..., None]
    char_grad = orders * torch.sin((orders + 1.0) * w) - (orders + 1.0) * torch.sin(orders * w)
    slope = (weighted * char_grad).sum(-1) / (1.0 - torch.cos(omega) + tol)
    slope = torch.where(omega <= tol, torch.zeros_like(slope), slope)
    return _finite_or_zero(slope)


def dlog_igso3_expansion(
    omega: torch.Tensor, sigma: torch.Tensor, orders: torch.Tensor, tol: float = 1e-7
) -> torch.Tensor:
    """``d/d(omega) log f = f' / f``: the radial part of the SO(3) score."""
    density = igso3_expansion(omega, sigma, orders, tol=tol)
    slope = digso3_expansion(omega, sigma, orders, tol=tol)
    return slope / (density + tol)


def uniform_so3_density(omega: torch.Tensor) -> torch.Tensor:
    """Angle density of the Haar-uniform SO(3) distribution, ``(1 - cos w) / pi``."""
    return (1.0 - torch.cos(omega)) / math.pi
