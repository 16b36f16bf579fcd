"""PPFT (property-prediction fine-tuning) of a control net on a frozen score
model: integrals, losses, h-functions and the trainer."""

from se3diff_torch.ppft.integrals import (
    compute_int_dws,
    compute_int_u_u_dt,
    compute_ws,
    riemannian_ito_integral,
    riemannian_quadratic_covariation,
    rloo_baseline,
)
from se3diff_torch.ppft.losses import compute_ev_loss, compute_kl_loss

__all__ = [
    "compute_int_dws",
    "compute_int_u_u_dt",
    "compute_ws",
    "riemannian_ito_integral",
    "riemannian_quadratic_covariation",
    "rloo_baseline",
    "compute_ev_loss",
    "compute_kl_loss",
]
