"""Process groups, row slabs, the training mesh and the batch helpers.

Counterpart of ``se3diff_tpu/parallel/mesh.py`` on ``torch.distributed``.
The JAX package lays its chips out as a ``("data", "model")`` mesh and lets
XLA place the shards; here every rank is a process that owns one device and
the port moves rows and partial sums itself:

* :func:`init_group` joins a rank to its group: NCCL when every rank has a
  CUDA device of its own, gloo otherwise (on the CPU, or when ranks share a
  card, which NCCL refuses).
* :func:`row_slabs` cuts ``L`` rows into near-equal contiguous ranges, one a
  rank. The port does not pad: the kernel masks ragged rows itself, so JAX's
  ``row_padded_len`` shard padding has no counterpart.
* :func:`gather_rows` is the all-gather of row slabs, written as an
  ``all_reduce`` of a zero-filled full-length buffer into which each rank
  copies its slab: one code path for both backends (gloo documents only
  broadcast and all_reduce for CUDA tensors), exact in f32 and bf16 because
  every entry is one slab's value plus zeros. It is an autograd Function:
  its backward sums the gradient over the group and returns the rank's
  slab of it (the all-gather's transpose, a reduce-scatter).
* :func:`init_mesh` lays the ranks of a group out as a ``data x model``
  grid (:class:`MeshContext`), model groups on contiguous ranks as in the
  JAX package's ``make_mesh``, with one process group for each row and
  each column of the grid.
* :func:`copy_in` and :func:`reduce_out` are the two collectives of tensor
  parallelism (TP) over the model group, each a ``torch.autograd.Function``:
  ``copy_in`` is the identity forward and sums the gradient over the group
  backward (the entry of a head-split region, whose replicated input gets a
  partial gradient on each rank; several tensors share one collective); ``reduce_out`` sums partial products
  forward and passes the gradient through backward (after a linear whose
  input features are split). Both reduce in f32 with ``all_reduce`` only.

The pure helpers (``round_up_batch``, ``good_batch_size``,
``largest_pow2_leq``, ``pick_model_parallel``) are copies of the JAX
package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import timedelta
from typing import Sequence

import torch
import torch.distributed as dist

# How long a rank waits for the others (rendezvous and every collective)
# before it fails instead of hanging.
DEFAULT_TIMEOUT = timedelta(minutes=30)


def round_up_batch(batch: int, n_data: int) -> int:
    """Smallest multiple of the data-axis size >= batch."""
    return -(-batch // n_data) * n_data


def good_batch_size(n_data: int, per_device: int) -> int:
    """Global batch divisible by the data axis."""
    return n_data * per_device


def largest_pow2_leq(n: int) -> int:
    return 1 << (int(math.log2(n)) if n > 0 else 0)


def pick_model_parallel(n_devices: int, n_heads: int) -> int:
    """Largest power-of-two model-parallel degree that divides both the
    device count and the head count (TP shards attention heads)."""
    mp = 1
    while mp * 2 <= n_devices and n_devices % (mp * 2) == 0 and n_heads % (mp * 2) == 0:
        mp *= 2
    return mp


def row_slabs(L: int, world: int) -> list[tuple[int, int]]:
    """``world`` contiguous row ranges ``(r0, r1)`` covering ``range(L)``:
    the first ``L % world`` one row longer than the rest (L=10 on 4 ranks:
    3, 3, 2, 2 rows)."""
    if world < 1 or L < world:
        raise ValueError(f"cannot cut {L} rows into {world} non-empty slabs")
    base, extra = divmod(L, world)
    bounds = [0]
    for r in range(world):
        bounds.append(bounds[-1] + base + (r < extra))
    return list(zip(bounds[:-1], bounds[1:]))


@dataclass(frozen=True)
class RankContext:
    """One rank's place in its group: the sequence-parallel (SP) context
    that the model carries, and the data-parallel (DP) sampler's group.
    ``group`` is the process group the collectives run on; the rank's row
    slab of a length-``L`` protein is :meth:`rows`."""

    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device

    def rows(self, L: int) -> tuple[int, int]:
        return row_slabs(L, self.world)[self.rank]


def _device(d: str | torch.device) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def init_group(
    rank: int,
    world: int,
    init_method: str,
    devices: Sequence[str | torch.device],
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> RankContext:
    """Join rank ``rank`` of ``world`` to the default process group and give
    it the device ``devices[rank]``. The backend is NCCL when the ranks'
    devices are distinct CUDA devices, gloo otherwise. ``timeout`` bounds the
    rendezvous and every collective, so a hung rank fails the others."""
    devs = [_device(d) for d in devices]
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    device = devs[rank]
    own_cards = all(d.type == "cuda" for d in devs) and len(set(devs)) == world
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if own_cards else "gloo", init_method=init_method, rank=rank,
        world_size=world, timeout=timeout,
    )
    return RankContext(group=dist.group.WORLD, rank=rank, world=world, device=device)


@dataclass(frozen=True)
class MeshContext:
    """One rank's place in a ``data x model`` grid of ``data * model``
    ranks: rank ``r`` has data index ``r // model`` and model index
    ``r % model``. ``model_group`` holds the rank's row of the grid (the
    ranks that share a batch shard and split the heads), ``data_group`` its
    column (the ranks that hold the same shard of the weights)."""

    rank: int
    data: int
    model: int
    device: torch.device
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def tp(self) -> "MeshContext | None":
        """What a model takes for tensor parallelism: this context, or None
        when the model axis has one rank."""
        return self if self.model > 1 else None

    def batch_rows(self, batch: int) -> tuple[int, int]:
        """The rank's rows ``(b0, b1)`` of a global batch of ``batch``."""
        return row_slabs(batch, self.data)[self.data_rank]


def init_mesh(ctx: RankContext, data: int, model: int) -> MeshContext:
    """The ``data x model`` grid over the ranks of ``ctx``'s group. Every rank
    of the group must call it, with the same arguments: it creates every
    row's and every column's process group, in one order on all ranks."""
    if data < 1 or model < 1 or data * model != ctx.world:
        raise ValueError(f"a data={data} x model={model} mesh needs {data * model} ranks, "
                         f"the group has {ctx.world}")
    rows = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    cols = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    return MeshContext(rank=ctx.rank, data=data, model=model, device=ctx.device,
                       data_group=cols[ctx.rank % model], model_group=rows[ctx.rank // model])


def _all_reduce_f32(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``, reduced in f32 and returned in
    ``x``'s dtype; ``x`` is left as it was."""
    y = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # Every gradient summed in one f32 buffer: one collective.
        flat = _all_reduce_f32(torch.cat([g.reshape(-1).float() for g in grads]), ctx.group)
        sums = flat.split([g.numel() for g in grads])
        return (None, *(s.view_as(g).to(g.dtype) for s, g in zip(sums, grads)))


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_in(x: torch.Tensor | tuple[torch.Tensor, ...],
            tp: MeshContext | None) -> torch.Tensor | tuple[torch.Tensor, ...]:
    """``x`` unchanged; backward, its gradient summed over ``tp``'s model
    group. ``x`` may be a tuple of tensors, whose gradients are then summed
    in one collective. The identity when ``tp`` is None."""
    if tp is None:
        return x
    if isinstance(x, torch.Tensor):
        return _CopyIn.apply(tp.model_group, x)[0]
    return _CopyIn.apply(tp.model_group, *x)


def reduce_out(x: torch.Tensor, tp: MeshContext | None) -> torch.Tensor:
    """``x`` summed over ``tp``'s model group (in f32, returned in ``x``'s
    dtype); backward, the gradient passed through. The identity when
    ``tp`` is None."""
    return x if tp is None else _ReduceOut.apply(x, tp.model_group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r0, r1, L, dim, group):
        ctx.r0, ctx.r1, ctx.dim, ctx.group = r0, r1, dim, group
        shape = list(x.shape)
        shape[dim] = L
        full = x.new_zeros(shape)
        full.narrow(dim, r0, r1 - r0).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        # The transpose of the all-gather: a reduce-scatter, written as an
        # f32 all_reduce of the whole gradient narrowed to the rank's slab.
        full = _all_reduce_f32(grad, ctx.group)
        return full.narrow(ctx.dim, ctx.r0, ctx.r1 - ctx.r0).contiguous(), None, None, None, None, None


def gather_rows(
    x: torch.Tensor, r0: int, r1: int, L: int, dim: int, group: dist.ProcessGroup | None = None
) -> torch.Tensor:
    """The full-length tensor from every rank's slab ``x`` (rows ``r0:r1``
    of ``L`` along ``dim``): zeros with the slab copied in, summed over the
    group. Every rank gets the same result, bit for bit. Differentiable:
    backward, the gradient summed over the group in f32 and narrowed to the
    rank's slab, so a rank's slab gets what every rank's use of the full
    tensor contributes."""
    if x.shape[dim] != r1 - r0:
        raise ValueError(f"slab has {x.shape[dim]} rows along dim {dim}, expected {r1 - r0}")
    return _GatherRows.apply(x, r0, r1, L, dim, group)
