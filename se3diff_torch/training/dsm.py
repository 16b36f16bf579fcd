"""Denoising score matching for SE(3) rigid-frame batches.

Counterpart of ``se3diff_tpu/training/dsm.py:34-114``. The loss is split in
two: :func:`draw_noise` draws the corruption (``t``, ``z``, ``rot_t``) from
an explicit ``torch.Generator``, and :func:`dsm_loss` takes that noise, so a
caller can feed both packages the same noise. Targets follow the DiG output
parameterisation (models.py:359-384): ``pos_raw`` predicts
``score * std = -z`` for the VP marginal, ``rot_raw`` predicts
``score / score_scaling`` with the IGSO(3) score of ``Log(x0^T x_t)``.

The score network trains with dropout inactive, as the JAX package's does
(its ``model_apply`` runs with ``deterministic=True``): :func:`train_step`
puts the model in eval mode. Its three parts, :func:`step_loss`,
:func:`step_backward` and :func:`step_update`, are public so that a
profiler can time each of them in the step it measures.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from se3diff_torch.diffusion.denoise import SDEs
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.sde.base import bcast_right


class DSMNoise(NamedTuple):
    """Corruption of one batch: ``t [B]``, ``z [B, L, 3]``, ``rot_t [B, L, 3, 3]``."""

    t: torch.Tensor
    z: torch.Tensor
    rot_t: torch.Tensor


def draw_noise(
    generator: torch.Generator, batch: dict, sdes: SDEs, min_t: float = 0.001
) -> DSMNoise:
    """``t ~ U[min_t, 1)``, ``z ~ N(0, 1)`` like ``pos``, and
    ``rot_t ~ IGSO3(rot, sigma(t))``, all from ``generator`` (on the device of
    the batch and of the SO(3) tables)."""
    pos0, rot0 = batch["pos"], batch["rot"]
    t = min_t + (1.0 - min_t) * torch.rand(
        pos0.shape[0], generator=generator, dtype=pos0.dtype, device=pos0.device
    )
    z = torch.randn(pos0.shape, generator=generator, dtype=pos0.dtype, device=pos0.device)
    rot_t = sdes.node_orientations.sample_marginal(generator, rot0, t)
    return DSMNoise(t, z, rot_t)


def dsm_loss(model: torch.nn.Module, batch: dict, noise: DSMNoise, sdes: SDEs) -> torch.Tensor:
    """Masked MSE between the model's raw outputs and the closed-form DSM
    targets for ``noise``.

    ``batch``: ``pos [B, L, 3]``, ``rot [B, L, 3, 3]`` clean frames,
    ``single``/``pair`` conditioning and an optional ``mask [B, L]``
    (True = real residue). ``single``/``pair``/``mask`` may come without the
    batch axis (``[L, S]``/``[L, L, P]``/``[L]``); they are expanded here.
    """
    pos0, rot0 = batch["pos"], batch["rot"]
    B, L = pos0.shape[:2]
    single, pair = batch["single"], batch["pair"]
    if single.ndim == 2:
        single = single.expand(B, *single.shape)
    if pair.ndim == 3:
        pair = pair.expand(B, *pair.shape)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones((B, L), dtype=torch.bool, device=pos0.device)
    elif mask.ndim == 1:
        mask = mask.expand(B, L)
    t, z, rot_t = noise

    # Positions: x_t = a x0 + std z; score * std = -z.
    a, std = sdes.pos.mean_coeff_and_std(pos0, t)
    pos_t = a * pos0 + std * z
    pos_target = -z

    # Rotations: target = score(Log(x0^T x_t)) / lambda(t).
    q_t = so3_ops.rotmat_to_rotvec(torch.einsum("...ji,...jk->...ik", rot0, rot_t))
    score = sdes.node_orientations.compute_score(q_t, t, method="series")
    scaling = sdes.node_orientations.get_score_scaling(t)
    rot_target = score / bcast_right(scaling, score)

    pos_raw, rot_raw = model(pos_t, rot_t, t, single, pair, mask)

    w = mask.to(pos0.dtype)[..., None]
    denom = w.sum().clamp(min=1.0) * 3.0
    loss_pos = (w * (pos_raw - pos_target).square()).sum() / denom
    loss_rot = (w * (rot_raw - rot_target).square()).sum() / denom
    return loss_pos + loss_rot


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``min(1, max_norm / ||grads||)``, optax's
    ``clip_by_global_norm`` (no epsilon in the denominator, unlike
    ``torch.nn.utils.clip_grad_norm_``). Stays on the device: no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))


def step_loss(
    model: torch.nn.Module, batch: dict, generator: torch.Generator, sdes: SDEs,
    min_t: float = 0.001,
) -> torch.Tensor:
    """The first part of :func:`train_step`: draw the noise and compute the
    loss, with dropout off, as in the JAX package's training."""
    model.eval()
    return dsm_loss(model, batch, draw_noise(generator, batch, sdes, min_t), sdes)


def step_backward(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """The second part of :func:`train_step`: fresh gradients of ``loss``."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()


def step_update(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer, *, lr: float,
    grad_clip: float | None = 1.0,
) -> None:
    """The last part of :func:`train_step`: clip, then AdamW at ``lr``."""
    if grad_clip is not None:
        clip_by_global_norm([p.grad for p in model.parameters() if p.grad is not None], grad_clip)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    generator: torch.Generator,
    sdes: SDEs,
    *,
    lr: float,
    min_t: float = 0.001,
    grad_clip: float | None = 1.0,
) -> torch.Tensor:
    """One single-device DSM step: draw noise, loss, backward, clip, AdamW at
    learning rate ``lr``. Returns the loss (a device tensor, not synced)."""
    loss = step_loss(model, batch, generator, sdes, min_t)
    step_backward(optimizer, loss)
    step_update(model, optimizer, lr=lr, grad_clip=grad_clip)
    return loss.detach()
