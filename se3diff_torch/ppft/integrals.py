"""Riemannian stochastic integrals for PPFT fine-tuning.

Counterpart of ``se3diff_tpu/ppft/integrals.py`` (reference
`bioemu/src/bioemu/ppft.py:4-78`). All take stacked paths ``[T, B, ...D]``
(time-major, as :class:`~se3diff_torch.diffusion.denoise.DenoisedSDEPath`
records them) and reduce over time and the trailing feature axis, returning
per-sample ``[B]`` (or ``[B, ...]`` for extra batch axes). Any float dtype,
float64 included.

The paths are recorded in reverse time (t: 1 -> 0), so the integrals are
taken against ``-dW`` / ``-dt``, as the reference does (ppft.py:57-61,
76-78).
"""

from __future__ import annotations

import torch


def riemannian_ito_integral(fs: torch.Tensor, dWs: torch.Tensor) -> torch.Tensor:
    """``einsum('tb...i,tb...i->b...')`` (ppft.py:4-13)."""
    return (fs * dWs).sum(dim=(0, -1))


def riemannian_quadratic_covariation(
    fs: torch.Tensor, gs: torch.Tensor, dts: torch.Tensor
) -> torch.Tensor:
    """``einsum('tb...i,tb...i,t->b...')`` (ppft.py:16-28). ``dts: [T]``."""
    dts = dts.reshape((-1,) + (1,) * (fs.ndim - 1))
    return (fs * gs * dts).sum(dim=(0, -1))


def rloo_baseline(fs: torch.Tensor) -> torch.Tensor:
    """Leave-one-out baseline over the batch axis (ppft.py:31-42)."""
    return (fs.sum(0, keepdim=True) - fs) / (fs.shape[0] - 1)


def compute_ws(*, us: torch.Tensor, dWs: torch.Tensor, dts: torch.Tensor) -> torch.Tensor:
    """Importance weights ``exp(int <u - sg(u), -dW> - 1/2 int |u - sg(u)|^2 dt)``:
    1 in value, the pathwise derivative of the measure change in gradient
    (ppft.py:45-62)."""
    diff = us - us.detach()
    int_diff_dw = riemannian_ito_integral(diff, -dWs)
    int_diff_diff_dt = riemannian_quadratic_covariation(diff, diff, -dts)
    return torch.exp(int_diff_dw - int_diff_diff_dt / 2.0)


def compute_int_dws(*, us: torch.Tensor, dWs: torch.Tensor) -> torch.Tensor:
    """Linearized importance weight ``int <u, -dW>``, whose gradient is the
    weight's (ppft.py:65-78)."""
    return riemannian_ito_integral(us, -dWs)


def compute_int_u_u_dt(*, us: torch.Tensor, dts: torch.Tensor) -> torch.Tensor:
    """``int |u|^2 (-dt)``, the reverse-time quadratic variation (ppft.py:140-149)."""
    return riemannian_quadratic_covariation(us, us, -dts)
