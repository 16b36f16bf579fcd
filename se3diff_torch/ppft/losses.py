"""PPFT expected-value and KL losses.

Counterpart of ``se3diff_tpu/ppft/losses.py`` (reference
`bioemu/src/bioemu/ppft.py:81-194`). Both support the ``from_int_dws``
linearization, where the gradient of the importance weight ``w`` is
estimated through ``int <u, -dW>``. Keyword names follow the reference.
"""

from __future__ import annotations

import torch

from se3diff_torch.ppft.integrals import rloo_baseline


def _stability_weights(hs: torch.Tensor, tol: float) -> torch.Tensor:
    """Per-observable reweighting ~ 1/mean(h), normalized to unit mean."""
    batch_mean = hs.mean(0)  # [K]
    inverse = batch_mean.sum() / (batch_mean + tol)
    return inverse / inverse.mean()


def compute_ev_loss(
    *,
    ws: torch.Tensor,
    hs: torch.Tensor,
    h_stars: torch.Tensor,
    from_int_dws: bool = True,
    use_stab: bool = True,
    tol: float = 1e-7,
) -> torch.Tensor:
    """Unbiased U-statistic estimator of ``(E[h] - h*)^2`` (ppft.py:81-137).

    ``ws [B]`` importance weights (or linearized ``int_dws``), ``hs [B, K]``,
    ``h_stars [K]`` or ``[B, K]``. With ``from_int_dws`` the ordered-pair
    kernel ``(w_i + w_j) r_i r_j`` reduces to ``2 [(w.r)(1.r) - w.r^2]`` per
    observable, so the gradient matches the full estimator at first order.
    """
    n = ws.shape[0]
    residual = hs - h_stars  # [B, K]
    scale = _stability_weights(hs, tol) if use_stab and n > 1 else 1.0
    if from_int_dws:
        first = torch.einsum("b,bk->k", ws, residual)
        plain = residual.sum(0)
        diagonal = torch.einsum("b,bk->k", ws, residual.square())
        per_observable = 2.0 * (first * plain - diagonal)
    else:
        weighted = ws[:, None] * residual  # [B, K]
        per_observable = weighted.sum(0).square() - weighted.square().sum(0)
    # Off-diagonal pair count normalizes the U-statistic.
    return (per_observable * scale).sum() / (n * (n - 1))


def compute_kl_loss(
    *,
    ws: torch.Tensor,
    int_u_u_dt: torch.Tensor,
    int_u_u_dt_sg: torch.Tensor,
    from_int_dws: bool = True,
    use_rloo: bool = True,
) -> torch.Tensor:
    """KL control cost ``1/2 E[w int |u|^2 dt]`` with the stop-gradient split
    (ppft.py:152-194). ``int_u_u_dt_sg`` is the full-path integral without
    gradient; RLOO reduces the variance of the score-function term."""
    if use_rloo:
        centered = int_u_u_dt - rloo_baseline(int_u_u_dt.detach())
        centered_sg = int_u_u_dt_sg - rloo_baseline(int_u_u_dt_sg)
    else:
        centered, centered_sg = int_u_u_dt, int_u_u_dt_sg
    if from_int_dws:
        objective = centered + centered_sg * ws
    else:
        # Validation with ws = 1.
        objective = centered * ws
    return 0.5 * objective.mean()
