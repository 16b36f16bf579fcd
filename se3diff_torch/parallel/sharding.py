"""Tensor-parallel (TP) layout of the DiG score network's parameters.

Counterpart of ``se3diff_tpu/parallel/sharding.py``: the same Megatron-style
split over the ``model`` axis, written against the port's parameter names.
JAX places the shards and lets GSPMD insert the collectives; here a model
built with ``tp`` (``models/dig.py``) holds its rank's shard of every split
parameter, and :func:`shard_state_dict` / :func:`gather_state_dict` move a
full state dict in and out of that layout.

A torch ``Linear.weight`` is ``[out, in]``, the transpose of a flax
``kernel``. So JAX's "shard the output features" (``P(None, "model")``) is a
split of the weight's rows (dim 0) and "shard the input features"
(``P("model", None)``) a split of its columns (dim 1). Model rank ``m`` of
``M`` takes the ``m``-th of ``M`` equal blocks of the split dim, which, as
every per-head feature dim is head-major, is head block ``m``.

``fc_out``'s input is the concatenation ``[out_scalar H*dk | out_point_local
H*24 | out_pair H*dk | out_point_norm H*8]`` (``models/dig.py``). JAX's spec
splits it as one block, which works because GSPMD reshards the activation;
the port computes each rank's heads' features in place, so model rank ``m``
takes head block ``m`` of each of the four segments.

Beyond JAX's twelve rules, ``ffn.ff.0.bias`` (fc1's bias) is split with
fc1's rows, so each rank adds the bias of its own hidden units; the biases
of ``fc_out`` and ``ffn.ff.3`` stay whole and are added once, after the
all-reduce. Every other parameter is replicated.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

# Port parameter-name suffix -> (the JAX rule's path suffix, split dim).
TP_RULES: dict[str, tuple[tuple[str, ...], int]] = {
    "attn.scalar_query.weight": (("attn", "scalar_query", "kernel"), 0),
    "attn.scalar_key.weight": (("attn", "scalar_key", "kernel"), 0),
    "attn.scalar_value.weight": (("attn", "scalar_value", "kernel"), 0),
    "attn.point_query.weight": (("attn", "point_query", "kernel"), 0),
    "attn.point_key.weight": (("attn", "point_key", "kernel"), 0),
    "attn.point_value.weight": (("attn", "point_value", "kernel"), 0),
    "attn.pair_bias.weight": (("attn", "pair_bias", "kernel"), 0),
    "attn.pair_value.weight": (("attn", "pair_value", "kernel"), 0),
    "attn.trained_point_weight": (("attn", "trained_point_weight"), 0),
    "attn.fc_out.weight": (("attn", "fc_out", "kernel"), 1),
    "ffn.ff.0.weight": (("ffn", "fc1", "kernel"), 0),
    "ffn.ff.3.weight": (("ffn", "fc2", "kernel"), 1),
}
# Split in the port with fc1's rows; JAX replicates it and lets GSPMD slice it.
_PORT_ONLY_RULES = {"ffn.ff.0.bias": 0}


def split_dim(name: str) -> int | None:
    """The dim along which parameter ``name`` is split over the model axis,
    or None when it is replicated."""
    for suffix, (_, dim) in TP_RULES.items():
        if name.endswith(suffix):
            return dim
    for suffix, dim in _PORT_ONLY_RULES.items():
        if name.endswith(suffix):
            return dim
    return None


def _segments(name: str, full_shape: tuple[int, ...], dim: int) -> list[int]:
    """The lengths of the head-major segments of the split dim: ``fc_out``'s
    four feature groups, one segment for every other parameter."""
    if not name.endswith("attn.fc_out.weight"):
        return [full_shape[dim]]
    d_model, n_in = full_shape
    heads = (n_in - 2 * d_model) // 32   # n_in = 2 d_model + H * (24 + 8)
    return [d_model, 24 * heads, d_model, 8 * heads]


def _shard_index(name: str, full_shape: tuple[int, ...], dim: int, rank: int,
                 world: int) -> torch.Tensor:
    """Indices along ``dim`` of the full tensor that model rank ``rank`` of
    ``world`` holds, in the order it holds them."""
    idx, start = [], 0
    for n in _segments(name, full_shape, dim):
        if n % world:
            raise ValueError(f"{name}: a segment of {n} along dim {dim} does not split "
                             f"into {world} equal blocks")
        block = n // world
        idx.append(torch.arange(start + rank * block, start + (rank + 1) * block))
        start += n
    return torch.cat(idx)


def shard_state_dict(full: Mapping[str, torch.Tensor], model_rank: int,
                     model: int) -> dict[str, torch.Tensor]:
    """Model rank ``model_rank``'s shard of a full state dict (every split
    parameter cut by the rules; the rest as it is)."""
    out = {}
    for name, t in full.items():
        dim = split_dim(name)
        if dim is None or model == 1:
            out[name] = t
        else:
            idx = _shard_index(name, tuple(t.shape), dim, model_rank, model)
            out[name] = t.index_select(dim, idx.to(t.device)).contiguous()
    return out


def gather_state_dict(local: Mapping[str, torch.Tensor],
                      group: dist.ProcessGroup) -> dict[str, torch.Tensor]:
    """The full state dict from every model rank's shard ``local``: each
    split tensor's shard copied into a full-shape tensor of negative zeros
    and summed over ``group`` (the model group), so every entry is one
    rank's value plus negative zeros: exact, the sign of a zero included;
    replicated tensors as they are. Every rank of ``group`` must call it;
    every rank gets the full state dict."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for name, t in local.items():
        dim = split_dim(name)
        if dim is None or world == 1:
            out[name] = t
            continue
        shape = list(t.shape)
        shape[dim] *= world
        full = t.new_full(shape, -0.0)
        idx = _shard_index(name, tuple(shape), dim, rank, world)
        full.index_copy_(dim, idx.to(t.device), t.detach())
        dist.all_reduce(full, group=group)
        out[name] = full
    return out
