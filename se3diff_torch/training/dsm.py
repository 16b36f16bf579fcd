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

:func:`mesh_train_step` is the DP+TP step of one rank of a ``data x model``
mesh, the counterpart of ``make_sharded_dsm_train_step``
(``se3diff_tpu/training/dsm.py:117-184``). :func:`sp_train_step` is the
step of a sequence-parallel (SP) rank, and :func:`pp_train_step` that of a
rank of a ``data x pipe`` pipeline-parallel (PP) grid; the JAX package
reaches both by composing its one-device step with a ``pair_sharding``
model or ``make_pp_score_fn``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from se3diff_torch.diffusion.denoise import SDEs
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.parallel.mesh import MeshContext, RankContext
from se3diff_torch.parallel.sharding import split_dim
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


def dsm_denominator(batch: dict) -> torch.Tensor:
    """The denominator of :func:`dsm_loss`: 3 times the batch's count of
    real residues (``mask``; every row when there is none), at least 3."""
    B, L = batch["pos"].shape[:2]
    mask = batch.get("mask")
    if mask is None:
        count = torch.tensor(float(B * L), device=batch["pos"].device)
    else:
        count = mask.to(batch["pos"].dtype).sum() * (B if mask.ndim == 1 else 1)
    return count.clamp(min=1.0) * 3.0


def dsm_loss(model: torch.nn.Module, batch: dict, noise: DSMNoise, sdes: SDEs,
             denom: torch.Tensor | None = None) -> torch.Tensor:
    """Masked MSE between the model's raw outputs and the closed-form DSM
    targets for ``noise``.

    ``batch``: ``pos [B, L, 3]``, ``rot [B, L, 3, 3]`` clean frames,
    ``single``/``pair`` conditioning and an optional ``mask [B, L]``
    (True = real residue). ``single``/``pair``/``mask`` may come without the
    batch axis (``[L, S]``/``[L, L, P]``/``[L]``); they are expanded here.
    ``denom`` is the masked sum's divisor, by default
    :func:`dsm_denominator` of ``batch``; a data-parallel rank passes the
    global batch's, so that the ranks' losses sum to the global loss.
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
    if denom is None:
        denom = dsm_denominator(batch)
    loss_pos = (w * (pos_raw - pos_target).square()).sum() / denom
    loss_rot = (w * (rot_raw - rot_target).square()).sum() / denom
    return loss_pos + loss_rot


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``min(1, max_norm / ||grads||)``, optax's
    ``clip_by_global_norm`` (no epsilon in the denominator, unlike
    ``torch.nn.utils.clip_grad_norm_``). Stays on the device: no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))


def _clip_sharded(named_grads: list[tuple[str, torch.Tensor]], max_norm: float,
                  group: dist.ProcessGroup, split: Callable[[str], bool]) -> None:
    """:func:`clip_by_global_norm` of the full model's gradients from one
    rank's: the squared norms of the parameters that ``split`` names (each
    rank of ``group`` holds its own part of them: a TP shard, a PP stage's
    layers) summed over ``group``, those of the replicated ones (equal on
    every rank) counted once."""
    sq = torch.zeros(2, dtype=torch.float32, device=named_grads[0][1].device)
    for i, part in enumerate((True, False)):
        grads = [g for n, g in named_grads if split(n) == part]
        if grads:
            sq[i] = torch.stack(torch._foreach_norm(grads)).square().sum()
    dist.all_reduce(sq[:1], group=group)
    grads = [g for _, g in named_grads]
    torch._foreach_mul_(grads, (max_norm / sq.sum().sqrt()).clamp(max=1.0))


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
    grad_clip: float | None = 1.0, tp: MeshContext | None = None,
    pp: MeshContext | None = None,
) -> None:
    """The last part of :func:`train_step`: clip, then AdamW at ``lr``. A
    tensor-parallel model (``tp``) and a pipeline stage (``pp``, whose
    model axis is the pipe) clip by the full model's norm
    (:func:`_clip_sharded`); AdamW runs on the rank's parameters as it is,
    being elementwise, and skips those without a gradient (the other
    stages' layers)."""
    if grad_clip is not None:
        named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
        if tp is not None:
            _clip_sharded(named, grad_clip, tp.model_group, lambda n: split_dim(n) is not None)
        elif pp is not None and pp.model > 1:
            _clip_sharded(named, grad_clip, pp.model_group, lambda n: ".encoder.layers." in n)
        else:
            clip_by_global_norm([g for _, g in named], grad_clip)
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


# The batch entries that may come without the batch axis, and their ndim then.
_UNBATCHED_NDIM = {"single": 2, "pair": 3, "mask": 1}


def _all_reduce_flat(tensors: list[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Sum every tensor of ``tensors`` (f32) over ``group`` in place, through
    one flat buffer: one collective however many tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, s in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(s.view_as(t))


def mesh_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    noise: DSMNoise,
    sdes: SDEs,
    mesh: MeshContext,
    *,
    lr: float,
    grad_clip: float | None = 1.0,
) -> torch.Tensor:
    """One DP+TP DSM step on one rank of ``mesh``: the step
    :func:`train_step` takes on the whole batch, split over ``mesh.data``
    batch shards and ``mesh.model`` head groups.

    ``batch`` and ``noise`` are the global batch and its noise (every rank
    passes the same; :func:`draw_noise` on the global batch gives what one
    process draws). ``model`` is built with ``tp=mesh.tp`` and holds the
    rank's shard; ``optimizer`` is over its parameters. The rank takes its
    rows ``mesh.batch_rows(B)``; its loss is its rows' masked sum over the
    global batch's :func:`dsm_denominator` (every rank holds the global
    mask, so no collective is needed for it). After :func:`step_backward`,
    every gradient, with the loss, is summed over the data group in one
    flat buffer; :func:`step_update` then clips by the full model's norm
    and takes the AdamW step on the rank's shards. Returns the global loss
    (a device tensor, equal on every rank)."""
    model.eval()
    b0, b1 = mesh.batch_rows(batch["pos"].shape[0])
    local = {k: v if v.ndim == _UNBATCHED_NDIM.get(k) else v[b0:b1] for k, v in batch.items()}
    loss = dsm_loss(model, local, DSMNoise(*(x[b0:b1] for x in noise)), sdes,
                    denom=dsm_denominator(batch))
    step_backward(optimizer, loss)
    loss = loss.detach().reshape(1)
    if mesh.data > 1:
        _all_reduce_flat([p.grad for p in model.parameters() if p.grad is not None] + [loss],
                         mesh.data_group)
    step_update(model, optimizer, lr=lr, grad_clip=grad_clip, tp=mesh.tp)
    return loss[0]


def sp_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    noise: DSMNoise,
    sdes: SDEs,
    sp: RankContext,
    *,
    lr: float,
    grad_clip: float | None = 1.0,
) -> torch.Tensor:
    """One DSM step on one rank of a sequence-parallel group: the step
    :func:`train_step` takes, with the pair stack's query rows split over
    ``sp.world`` ranks.

    ``model`` is built with ``sp=sp``; every rank passes the whole batch
    and the same ``noise`` (the batch is replicated: :func:`draw_noise`
    from a generator seeded alike on every rank gives it). The loss,
    the diff head and the score heads after the last ``gather_rows`` run
    replicated on every rank, so each rank backpropagates its loss divided
    by the group's size; ``gather_rows``' backward sums what flows into
    each slab. The parameter gradients are then summed over the group in
    one flat buffer, which leaves every rank with the full gradient, and
    the clip and AdamW run as in :func:`train_step`, identically on every
    rank. Returns the loss (a device tensor, equal on every rank)."""
    model.eval()
    loss = dsm_loss(model, batch, noise, sdes)
    step_backward(optimizer, loss / sp.world)
    if sp.world > 1:
        _all_reduce_flat([p.grad for p in model.parameters() if p.grad is not None], sp.group)
    step_update(model, optimizer, lr=lr, grad_clip=grad_clip)
    return loss.detach()


def pp_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    noise: DSMNoise,
    sdes: SDEs,
    mesh: MeshContext,
    score_fn: Callable,
    *,
    lr: float,
    grad_clip: float | None = 1.0,
) -> torch.Tensor:
    """One DSM step on one rank of a ``data x pipe`` grid (``mesh``, its
    model axis the pipe): :func:`mesh_train_step` with the model run by
    ``score_fn``, a :func:`~se3diff_torch.parallel.pipeline.make_pp_score_fn`
    of ``model`` on ``mesh``.

    ``batch`` and ``noise`` are the global ones; the rank takes its data
    shard's rows, and its loss is their masked sum over the global
    denominator. The pipeline leaves every stage with the full gradient of
    the replicated parameters (embeddings, diff head) and its own layers'
    gradients; the other layers get none. Every gradient, with the loss,
    is summed over the data group; the clip takes the full model's norm
    (the stages' layers summed over the pipe group) and AdamW steps the
    parameters that have a gradient. Returns the global loss."""
    model.eval()
    b0, b1 = mesh.batch_rows(batch["pos"].shape[0])
    local = {k: v if v.ndim == _UNBATCHED_NDIM.get(k) else v[b0:b1] for k, v in batch.items()}
    loss = dsm_loss(score_fn, local, DSMNoise(*(x[b0:b1] for x in noise)), sdes,
                    denom=dsm_denominator(batch))
    step_backward(optimizer, loss)
    loss = loss.detach().reshape(1)
    if mesh.data > 1:
        _all_reduce_flat([p.grad for p in model.parameters() if p.grad is not None] + [loss],
                         mesh.data_group)
    step_update(model, optimizer, lr=lr, grad_clip=grad_clip, pp=mesh)
    return loss[0]
