"""GPipe-style pipeline parallelism (PP) for the DiG trunk on ``torch.distributed``.

Counterpart of ``se3diff_tpu/parallel/pipeline.py``. The trunk's ``n_layer``
identical IPA blocks are cut into ``S`` contiguous *stages*, one a rank of
a pipe group, and the batch into ``M`` *microbatches* that stream through
the stages: ticks ``t = 0 .. M+S-2``, stage ``d`` running microbatch
``m = t - d`` when ``0 <= m < M`` (bubble fraction ``(S-1)/(M+S-1)``).

The grid is :func:`~se3diff_torch.parallel.mesh.init_mesh`'s ``data x
model`` layout with the second axis as the pipe: the stages of one data
row on contiguous ranks (``mesh.model_rank`` is the stage,
``mesh.model_group`` the pipe group), every data row pipelining its own
shard of the batch; a train step sums the gradients over the data group
(``training/dsm.py::pp_train_step``).

Every rank holds the whole model and computes the conditioning (``x1d``,
``x2d``, the column bias) and the diff head replicated, as the JAX
package's GSPMD program does outside its ``shard_map``; a stage builds the
pair bias ``pa`` of its own layers only. In between, one
``torch.autograd.Function`` runs the whole pipelined trunk:

* forward, the ticks without autograd, keeping each stage input;
* backward, the ticks in reverse: each stage recomputes its tick from the
  kept input with autograd (JAX's ``jax.checkpoint`` remat of a stage),
  backpropagates the gradient of its output and hands the gradient of its
  input to the previous stage.

Every rank of a pipe group makes one collective a tick, forward and
backward, bubble ticks included, so the collectives line up on every rank.
A hop is written as :func:`~se3diff_torch.parallel.mesh.gather_rows` is:
an ``all_reduce`` of a zero-filled ``[S, mB, L, d_model]`` buffer into
which each stage copies its output (gloo documents only ``all_reduce`` and
``broadcast`` for CUDA tensors; exact in f32 and bf16, every entry being
one stage's value plus zeros). Stage ``d`` reads slot ``d - 1`` forward
and slot ``d + 1`` backward, and every rank reads the last stage's slot,
so the trunk's output is replicated over the pipe group without a further
collective (JAX's ``psum`` over the pipe). Its gradient passes through
unsummed (the port's ``reduce_out``): every rank computes the same loss.
The replicated inputs get a partial gradient on each stage; one
:func:`~se3diff_torch.parallel.mesh.copy_in` at the trunk's entry sums
them over the pipe group. A stage's parameters get their gradient on its
rank only.

The JAX body runs the unfused XLA attention; here a stage runs K1 on its
microbatch (``M * n_layer / S`` launches a rank a forward, as many again in
a backward's recompute).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from se3diff_torch.models.dig import DiGConditionalScoreModel, SAEncoderLayer
from se3diff_torch.parallel.mesh import MeshContext, copy_in

__all__ = ["make_pp_score_fn", "stage_layers"]


def stage_layers(model: DiGConditionalScoreModel, stage: int, n_stages: int) -> range:
    """Indices of stage ``stage``'s ``n_layer / n_stages`` contiguous layers:
    what the JAX package's ``stack_layer_params`` reshaped to ``[S,
    n_layer/S, ...]`` and ``pp_stage_param_specs`` shard over the pipe give a
    device."""
    n_layer = len(model.model_nn.st_module.encoder.layers)
    if n_layer % n_stages != 0:
        raise ValueError(f"num_layers={n_layer} not divisible by {n_stages} stages")
    per = n_layer // n_stages
    return range(stage * per, (stage + 1) * per)


def _microbatch(x: torch.Tensor, m: int, dim: int = 0) -> torch.Tensor:
    """``x`` with its batch axis ``dim`` split into ``[m, b / m]`` (a view)."""
    b = x.shape[dim]
    return x.unflatten(dim, (m, b // m))


@dataclass(frozen=True)
class _Stage:
    """One rank's stage of the pipeline."""

    layers: tuple[SAEncoderLayer, ...]
    stage: int
    n_stages: int
    n_microbatches: int
    group: dist.ProcessGroup | None

    def run(self, x, x2d, T, IR, bias, pa):
        """The stage's layers on one microbatch; ``pa`` holds their pair
        biases, ``[layers, mB, H, L, L]``."""
        for i, layer in enumerate(self.layers):
            x = layer(x, x2d, (T, IR), bias, pa[i], None)
        return x

    def hop(self, y: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
        """Every stage's ``y`` (zeros where a stage passes None), as
        ``[S, *like.shape]`` on every rank of the pipe group."""
        buf = like.new_zeros((self.n_stages, *like.shape))
        if y is not None:
            buf[self.stage].copy_(y)
        if self.n_stages > 1:
            dist.all_reduce(buf, group=self.group)
        return buf


class _PipelinedTrunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage: _Stage, x1d, x2d, T, IR, bias, pa, *params):
        d, S, M = stage.stage, stage.n_stages, stage.n_microbatches
        mb = [_microbatch(x, M) for x in (x1d, x2d, T, IR, bias)]
        pa_mb = _microbatch(pa, M, dim=1)
        like = mb[0][0]
        out = torch.empty_like(mb[0])
        states, state = {}, None
        for t in range(M + S - 1):
            m, y = t - d, None
            if 0 <= m < M:
                x = mb[0][m] if d == 0 else state
                if d > 0:
                    states[m] = x
                y = stage.run(x, *(a[m] for a in mb[1:]), pa_mb[:, m])
            buf = stage.hop(y, like)
            state = buf[d - 1] if d > 0 else None
            if 0 <= t - (S - 1) < M:
                out[t - (S - 1)] = buf[S - 1]
        ctx.stage, ctx.states = stage, states
        ctx.save_for_backward(x1d, x2d, T, IR, bias, pa, *params)
        return out.flatten(0, 1)

    @staticmethod
    def backward(ctx, g_out):
        stage = ctx.stage
        d, S, M = stage.stage, stage.n_stages, stage.n_microbatches
        x1d, x2d, T, IR, bias, pa, *params = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        mb = [_microbatch(x, M) for x in (x1d, x2d, T, IR, bias)]
        pa_mb = _microbatch(pa, M, dim=1)
        g_out = _microbatch(g_out, M)
        like = mb[0][0]
        # Gradients of x1d, x2d, T, IR, (bias), pa, then the parameters.
        grads = [torch.zeros_like(x) if n and i != 4 else None
                 for i, (x, n) in enumerate(zip((x1d, x2d, T, IR, bias, pa), need))]
        g_mb = [None if g is None else _microbatch(g, M, dim=1 if i == 5 else 0)
                for i, g in enumerate(grads)]
        g_params = [None] * len(params)
        g_next = None
        for t in reversed(range(M + S - 1)):
            m, g_in = t - d, None
            if 0 <= m < M:
                g_y = g_out[m] if d == S - 1 else g_next
                x = mb[0][m] if d == 0 else ctx.states[m]
                leaves = [x, *(a[m] for a in mb[1:]), pa_mb[:, m]]
                leaves = [a.detach().requires_grad_((d > 0 or n) if i == 0 else n and i != 4)
                          for i, (a, n) in enumerate(zip(leaves, need))]
                wrt = [a for a in leaves if a.requires_grad]
                wrt_params = [p for p, n in zip(params, need[6:]) if n]
                with torch.enable_grad():
                    y = stage.run(*leaves)
                    got = torch.autograd.grad(y, wrt + wrt_params, g_y, allow_unused=True)
                got_inputs = iter(got[:len(wrt)])
                for i, a in enumerate(leaves):
                    if not a.requires_grad:
                        continue
                    g = next(got_inputs)
                    if i == 0 and d > 0:
                        g_in = g
                    elif g is not None:
                        (g_mb[i][m] if i < 5 else g_mb[5][:, m]).add_(g)
                got_params = iter(got[len(wrt):])
                for j, n in enumerate(need[6:]):
                    if n:
                        g = next(got_params)
                        if g is not None:
                            g_params[j] = g if g_params[j] is None else g_params[j] + g
            buf = stage.hop(g_in, like)
            g_next = buf[d + 1] if d < S - 1 else None
        return (None, *grads, *g_params)


def make_pp_score_fn(model: DiGConditionalScoreModel, mesh: MeshContext, n_microbatches: int):
    """A pipeline-parallel ``model_apply`` for ``model`` on ``mesh`` (an
    :func:`~se3diff_torch.parallel.mesh.init_mesh` grid whose model axis
    is the pipe, ``S = mesh.model`` stages).

    Returns ``fn(pos, rot, t, single, pair, mask=None) -> (pos_raw,
    rot_raw)``, equal to ``model(pos, rot, t, single, pair, mask)`` on the
    rows it is given (the data shard's batch), with the trunk run as an
    ``S``-stage pipeline of ``n_microbatches`` microbatches; the result is
    replicated over the pipe group. Every rank of the group calls it with
    the same inputs. ``model`` holds the whole model (a rank uses its
    stage's layers, :func:`stage_layers`) with dropout off (``eval()``),
    without SP or TP. Constraints, as in the JAX package: ``num_layers %
    S == 0`` (else ``ValueError`` "not divisible"), the batch a multiple of
    ``n_microbatches``."""
    S, M = mesh.model, n_microbatches
    layers_idx = stage_layers(model, mesh.model_rank, S)
    net = model.model_nn
    if net.sp is not None or net.tp is not None:
        raise ValueError("a pipeline stage takes a model without sequence or tensor parallelism")
    if M < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {M}")
    all_layers = net.st_module.encoder.layers
    stage = _Stage(tuple(all_layers[i] for i in layers_idx), mesh.model_rank, S, M,
                   mesh.model_group)
    params = [p for layer in stage.layers for p in layer.parameters()]

    def pp_trunk(pose, x1d, x2d, bias, pa, sp):
        """``st_module``'s stand-in: the pipelined layers, then the diff head."""
        if model.training:
            raise ValueError("the pipeline runs with dropout off: call model.eval()")
        B = x1d.shape[0]
        if B % M != 0:
            raise ValueError(f"batch {B} must be a multiple of n_microbatches = {M}: each data "
                             "shard pipelines its own microbatches")
        # Replicated inputs: their gradients, partial on each stage, are
        # summed over the pipe group.
        x1d, x2d, T, IR = copy_in((x1d, x2d, *pose), mesh if S > 1 else None)
        dt = net.dtype
        pa = torch.stack([torch.einsum("bijp,hp->bhij", x2d, layer.attn.pair_bias.weight.to(dt))
                          for layer in stage.layers]).contiguous()
        h = _PipelinedTrunk.apply(stage, x1d, x2d, T, IR, bias, pa, *params)
        return net.st_module.diff_head(h)

    def pp_apply(pos, rot, t, single, pair, mask=None):
        cache = model.embed_conditioning(single, pair, mask, with_pa=False)
        return model.score_from_cache(pos, rot, t, cache, trunk_fn=pp_trunk)

    return pp_apply

