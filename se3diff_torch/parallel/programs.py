"""Rank programs for :func:`~se3diff_torch.parallel.launch.run_ranks`.

Each takes the rank's :class:`~se3diff_torch.parallel.mesh.RankContext` and
picklable arguments (numpy arrays, plain values), builds what it needs on
the rank's device and returns numpy or plain values. They drive the
sequence-parallel (SP) score network, the SP sampling pipeline,
data-parallel (DP) sampling, the DP+TP train step, the train CLI's ranks
(:func:`train_rank`, which ``python -m se3diff_torch.train --mesh`` spawns),
the training example's ranks (:func:`example_rank`, which
``examples/torch_train_from_scratch.py --mesh`` spawns),
the SP train step and the pipeline-parallel (PP) score and train step, and
are what the test suite and ``chip_smoke.py`` run on each rank to hold the
multi-rank paths against one process.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Callable, Sequence
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from se3diff_torch import train
from se3diff_torch.diffusion.denoise import SDEs
from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights
from se3diff_torch.ops import ipa_attention as k1
from se3diff_torch.parallel.mesh import RankContext, gather_rows, init_mesh
from se3diff_torch.parallel.pipeline import make_pp_score_fn
from se3diff_torch.parallel.sample import sample_batch_sharded
from se3diff_torch.parallel.sharding import gather_state_dict, shard_state_dict
from se3diff_torch.sampling.bundle import random_bundle
from se3diff_torch.sampling.pipeline import sample
from se3diff_torch.sde.so3_sde import DiGSO3SDE
from se3diff_torch.sde.vpsde import CosineVPSDE
from se3diff_torch.training.data import MultiEnsembleDataset
from se3diff_torch.training.dsm import (
    DSMNoise,
    draw_noise,
    mesh_train_step,
    pp_train_step,
    sp_train_step,
)
from se3diff_torch.training.loop import TrainConfig, make_optimizer, train_dsm


def in_turn(ctx: RankContext, steps: Sequence[tuple[Callable, tuple]]) -> list[Any]:
    """Run several programs ``(fn, args)`` on one rank, in order, in one
    group: one spawn for all of them."""
    return [fn(ctx, *args) for fn, args in steps]


def _reset_k1() -> None:
    k1.launches = k1.backward_calls = 0
    k1.launches_by_route.update(dict.fromkeys(k1.launches_by_route, 0))
    k1.backward_calls_by_route.update(dict.fromkeys(k1.backward_calls_by_route, 0))


def _synchronize(ctx: RankContext) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def sp_score(
    ctx: RankContext,
    model_cfg: dict,
    weights: dict[str, np.ndarray] | int,
    inputs: Sequence[np.ndarray],
    dtype: str = "float32",
) -> dict[str, Any]:
    """One score evaluation of the SP model: ``embed_conditioning`` of
    ``single``/``pair`` (and ``mask``, when ``inputs`` holds one) and
    ``score_from_cache`` at ``(pos, rot, t)``. ``weights`` is a state dict,
    or a seed for :func:`~se3diff_torch.models.dig.init_weights`. Returns
    the full ``pos``/``rot`` outputs, the rank's row slab, and its K1
    launches, in all and by route."""
    k1.check_card_widths(model_cfg, ctx.device, getattr(torch, dtype))
    model = DiGConditionalScoreModel(**model_cfg, dtype=getattr(torch, dtype), sp=ctx)
    if isinstance(weights, int):
        init_weights(model, torch.Generator().manual_seed(weights))
    else:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()}, strict=True)
    model.to(ctx.device).eval()
    pos, rot, t, single, pair, *mask = (torch.as_tensor(x).to(ctx.device) for x in inputs)
    launches, routes = k1.launches, dict(k1.launches_by_route)
    with torch.inference_mode():
        cache = model.embed_conditioning(single, pair, *mask)
        out = model.score_from_cache(pos, rot, t, cache)
    _synchronize(ctx)
    return {
        "pos": out[0].float().cpu().numpy(), "rot": out[1].float().cpu().numpy(),
        "rows": ctx.rows(pos.shape[1]), "launches": k1.launches - launches,
        "launches_by_route": _routes_since(routes),
    }


def _routes_since(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in k1.launches_by_route.items()}


def sp_sample(
    ctx: RankContext, bundle_kwargs: dict, sample_kwargs: dict, warmup_dir: str | None = None
) -> dict[str, Any]:
    """``sampling.pipeline.sample`` through an SP bundle
    (``random_bundle(**bundle_kwargs)`` on the rank's device). With
    ``warmup_dir``, one batch runs there first. Returns the rank's K1
    launches in the measured run, in all and by route (the counts are
    zeroed just before it), its wall time and its peak device memory (None
    on the CPU)."""
    bundle = random_bundle(**bundle_kwargs, device=ctx.device, sp=ctx)
    if warmup_dir is not None:
        sample(**{**sample_kwargs, "num_samples": sample_kwargs["batch_size"],
                  "output_dir": warmup_dir}, bundle=bundle)
    _synchronize(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _reset_k1()
    t0 = time.perf_counter()
    sample(**sample_kwargs, bundle=bundle)
    _synchronize(ctx)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else None
    return {"launches": k1.launches, "launches_by_route": dict(k1.launches_by_route),
            "wall_s": wall, "peak_bytes": peak, "rank": ctx.rank}


def dp_sample(
    ctx: RankContext, bundle_kwargs: dict, single: np.ndarray, pair: np.ndarray,
    batch: int, seed: int,
) -> dict[str, Any]:
    """One DP batch (``parallel.sample.sample_batch_sharded``) from a bundle
    ``random_bundle(**bundle_kwargs)`` on the rank's device, with the rank's
    K1 launches by route in it."""
    bundle = random_bundle(**bundle_kwargs, device=ctx.device)
    routes = dict(k1.launches_by_route)
    out = sample_batch_sharded(bundle, ctx, single, pair, batch, seed)
    return {**out, "launches_by_route": _routes_since(routes)}


def _tensors(x, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in x.items()}


def _numpy(sd: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Copies: what a later step changes in place stays as it was here."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in sd.items()}


def shard_round_trip(ctx: RankContext, data: int, model: int,
                     weights: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``weights`` cut to the rank's model shard
    (:func:`~se3diff_torch.parallel.sharding.shard_state_dict`) on its
    device and gathered back over the model group."""
    mesh = init_mesh(ctx, data, model)
    shard = shard_state_dict(_tensors(weights, ctx.device), mesh.model_rank, model)
    return _numpy(gather_state_dict(shard, mesh.model_group))


def mesh_step(
    ctx: RankContext, data: int, model: int, model_cfg: dict, weights: dict[str, np.ndarray],
    batch: dict[str, np.ndarray], noise: Sequence[np.ndarray], so3_kwargs: dict, *,
    lr: float, timed_steps: int = 0,
) -> dict[str, Any]:
    """One f32 DP+TP DSM step
    (:func:`~se3diff_torch.training.dsm.mesh_train_step`) on a ``data x
    model`` mesh from full ``weights``, on the global ``batch`` with the
    global ``noise`` ``(t, z, rot_t)``, with the train loop's defaults
    (``TrainConfig(lr)``: AdamW, the global-norm clip). Returns the
    global loss, the updated full weights and the step's clipped full
    gradients, gathered over the model group (numpy), and the rank's K1
    forward launches by route and backward passes (in all and by backward
    route) in the step. With
    ``timed_steps``, that many more steps follow on the same inputs, timed
    (``step_ms``), then as many with a device synchronization before and
    after every ``all_reduce`` (``all_reduce_ms``, ``all_reduces``: their
    wall and count a step; the wall includes the wait for the other ranks,
    not only the transfer)."""
    mesh = init_mesh(ctx, data, model)
    dev = ctx.device
    net = DiGConditionalScoreModel(**model_cfg, tp=mesh.tp)
    full = {k: torch.as_tensor(v) for k, v in weights.items()}
    net.load_state_dict(shard_state_dict(full, mesh.model_rank, model), strict=True)
    net.to(dev)
    sdes = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**so3_kwargs, device=dev))
    cfg = TrainConfig(lr=lr)
    opt = make_optimizer(cfg, net.parameters())
    b = _tensors(batch, dev)
    nz = DSMNoise(*(torch.as_tensor(x).to(dev) for x in noise))

    def step():
        return mesh_train_step(net, opt, b, nz, sdes, mesh, lr=lr, grad_clip=cfg.grad_clip)

    _reset_k1()
    loss = float(step())
    out = {"loss": loss, "launches_by_route": dict(k1.launches_by_route),
           "backward_calls": k1.backward_calls,
           "backward_calls_by_route": dict(k1.backward_calls_by_route),
           "weights": _numpy(gather_state_dict(net.state_dict(), mesh.model_group)),
           "grads": _numpy(gather_state_dict({n: p.grad for n, p in net.named_parameters()},
                                             mesh.model_group))}
    if timed_steps:
        times = []
        for _ in range(timed_steps):
            _synchronize(ctx)
            t0 = time.perf_counter()
            step()
            _synchronize(ctx)
            times.append(time.perf_counter() - t0)
        reduce_s, calls, all_reduce = [0.0], [0], dist.all_reduce

        def timed(*a, **kw):
            _synchronize(ctx)
            t0 = time.perf_counter()
            res = all_reduce(*a, **kw)
            _synchronize(ctx)
            reduce_s[0] += time.perf_counter() - t0
            calls[0] += 1
            return res

        with mock.patch.object(dist, "all_reduce", timed):
            for _ in range(timed_steps):
                step()
        out.update(step_ms=[1e3 * t for t in times],
                   all_reduce_ms=1e3 * reduce_s[0] / timed_steps,
                   all_reduces=calls[0] / timed_steps)
    return out


class _Interrupt(Exception):
    pass


def train_rank(ctx: RankContext, argv: Sequence[str], data: int, model: int,
               stop_at: int | None = None) -> dict[str, Any]:
    """One rank of ``python -m se3diff_torch.train`` with ``argv`` on a
    ``data x model`` mesh (:func:`se3diff_torch.train.run`): what the CLI's
    ``--mesh`` spawns on every rank. With ``stop_at``, every rank stops when
    it asks for step ``stop_at``'s batch, as an interrupted run stops, and
    returns. Returns the logged global losses, the run's wall, and the
    rank's K1 forward launches by route and backward passes (in all and by
    backward route)."""
    logging.basicConfig(level=logging.INFO)
    args = train.build_parser().parse_args(list(argv))
    mesh = init_mesh(ctx, data, model)
    batch_fn = MultiEnsembleDataset.batch_fn

    def stopping(self, *a, **kw):
        fn = batch_fn(self, *a, **kw)

        def step_fn(step):
            if step == stop_at:
                raise _Interrupt
            return fn(step)
        return step_fn

    _reset_k1()
    t0 = time.perf_counter()
    history = None
    patch = (contextlib.nullcontext() if stop_at is None
             else mock.patch.object(MultiEnsembleDataset, "batch_fn", stopping))
    with patch:
        try:
            history = train.run(args, mesh)
        except _Interrupt:
            pass
    _synchronize(ctx)
    return {"history": history, "wall_s": time.perf_counter() - t0, "rank": ctx.rank,
            "launches_by_route": dict(k1.launches_by_route),
            "backward_calls": k1.backward_calls,
            "backward_calls_by_route": dict(k1.backward_calls_by_route)}


def example_rank(ctx: RankContext, steps: int, ckpt_dir: str, data: int, model: int,
                 trajectory: Sequence[str] | None = None, topology: Sequence[str] | None = None,
                 batch_size: int = 8) -> dict[str, Any]:
    """One rank of ``examples/torch_train_from_scratch.py --mesh``: the
    example's training (:mod:`se3diff_torch.training.example`) on a ``data x
    model`` mesh, what the example spawns on every rank. Every rank builds
    the example's global batches and the full seed-0 weights, keeps its
    shard and runs ``train_dsm`` with its mesh; rank 0 writes the
    checkpoints in the one-device layout. Returns the logged global losses,
    the run's wall, the rank's K1 forward launches by route and backward
    passes (in all and by backward route), and on rank 0 the trained full
    weights (numpy, gathered over its model group)."""
    from se3diff_torch.training import example as ex

    logging.basicConfig(level=logging.INFO)
    mesh = init_mesh(ctx, data, model)
    batch_fn, _ = ex.batch_source(trajectory, topology, batch_size, ctx.device)
    full = ex.build_model(ex.JAX_MODEL, "cpu").state_dict()
    net = DiGConditionalScoreModel(**ex.JAX_MODEL, tp=mesh.tp)
    net.load_state_dict(shard_state_dict(full, mesh.model_rank, mesh.model), strict=True)
    net.to(ctx.device)
    sdes = ex.make_sdes(ctx.device)
    _reset_k1()
    t0 = time.perf_counter()
    net, history = train_dsm(sdes, net, batch_fn, ex.train_config(steps, ckpt_dir),
                             val_batch=batch_fn(10_000), mesh=mesh)
    _synchronize(ctx)
    out = {"history": history, "wall_s": time.perf_counter() - t0, "rank": ctx.rank,
           "launches_by_route": dict(k1.launches_by_route), "backward_calls": k1.backward_calls,
           "backward_calls_by_route": dict(k1.backward_calls_by_route)}
    weights = gather_state_dict(net.state_dict(), mesh.model_group)
    if ctx.rank == 0:
        out["weights"] = _numpy(weights)
    return out


def gather_rows_probe(ctx: RankContext, w: np.ndarray, x: np.ndarray) -> dict[str, np.ndarray]:
    """Two row-split products through :func:`~se3diff_torch.parallel.mesh.
    gather_rows`: ``y = W[slab] @ x``, gathered, ``z = W[slab] @ y``,
    gathered, loss ``sum(z^2) / world``. Returns the rank's gradients of
    ``W`` and ``x``; summed over the ranks they are the gradients of
    ``sum((W @ W @ x)^2)``."""
    L = w.shape[0]
    r0, r1 = ctx.rows(L)
    W = torch.tensor(w, requires_grad=True)
    X = torch.tensor(x, requires_grad=True)
    y = gather_rows(W[r0:r1] @ X, r0, r1, L, dim=0, group=ctx.group)
    z = gather_rows(W[r0:r1] @ y, r0, r1, L, dim=0, group=ctx.group)
    (z.square().sum() / ctx.world).backward()
    return {"w": W.grad.numpy(), "x": X.grad.numpy(), "z": z.detach().numpy()}


def _dsm_setup(ctx: RankContext, model: torch.nn.Module, weights: dict[str, np.ndarray],
               so3_kwargs: dict, lr: float):
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()}, strict=True)
    model.to(ctx.device)
    sdes = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**so3_kwargs, device=ctx.device))
    return sdes, make_optimizer(TrainConfig(lr=lr), model.parameters())


def sp_step(
    ctx: RankContext, model_cfg: dict, weights: dict[str, np.ndarray],
    batch: dict[str, np.ndarray], noise: Sequence[np.ndarray], so3_kwargs: dict, *,
    lr: float, dtype: str = "float32",
) -> dict[str, Any]:
    """One DSM step of the SP model
    (:func:`~se3diff_torch.training.dsm.sp_train_step`) from full
    ``weights`` on the whole ``batch`` with ``noise`` ``(t, z, rot_t)``,
    with the train loop's defaults (``TrainConfig(lr)``). Returns the loss,
    the step's clipped gradients and updated weights (numpy), the rank's
    row slab and its K1 forward launches by route and backward passes (in
    all and by backward route)."""
    k1.check_card_widths(model_cfg, ctx.device, getattr(torch, dtype))
    model = DiGConditionalScoreModel(**model_cfg, dtype=getattr(torch, dtype), sp=ctx)
    sdes, opt = _dsm_setup(ctx, model, weights, so3_kwargs, lr)
    b = _tensors(batch, ctx.device)
    nz = DSMNoise(*(torch.as_tensor(x).to(ctx.device) for x in noise))
    _reset_k1()
    loss = float(sp_train_step(model, opt, b, nz, sdes, ctx, lr=lr))
    _synchronize(ctx)
    return {"loss": loss, "rows": ctx.rows(b["pos"].shape[1]),
            "launches_by_route": dict(k1.launches_by_route), "backward_calls": k1.backward_calls,
            "backward_calls_by_route": dict(k1.backward_calls_by_route),
            "weights": _numpy(model.state_dict()),
            "grads": _numpy({n: p.grad for n, p in model.named_parameters()})}


def _pp_model(ctx: RankContext, data: int, pipe: int, model_cfg: dict,
              weights: dict[str, np.ndarray], dtype: str):
    k1.check_card_widths(model_cfg, ctx.device, getattr(torch, dtype))
    mesh = init_mesh(ctx, data, pipe)
    model = DiGConditionalScoreModel(**model_cfg, dtype=getattr(torch, dtype))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()}, strict=True)
    return mesh, model.to(ctx.device).eval()


def pp_score(
    ctx: RankContext, data: int, pipe: int, model_cfg: dict, weights: dict[str, np.ndarray],
    inputs: Sequence[np.ndarray], n_microbatches: int, dtype: str = "float32",
) -> dict[str, Any]:
    """One score evaluation through
    :func:`~se3diff_torch.parallel.pipeline.make_pp_score_fn` on a ``data x
    pipe`` grid: ``inputs`` are the global ``(pos, rot, t, single, pair[,
    mask])``, of which the rank's data shard takes its rows. Returns its
    rows' outputs, the rows and the rank's K1 launches by route."""
    mesh, model = _pp_model(ctx, data, pipe, model_cfg, weights, dtype)
    fn = make_pp_score_fn(model, mesh, n_microbatches)
    b0, b1 = mesh.batch_rows(inputs[0].shape[0])
    args = [torch.as_tensor(np.array(x[b0:b1])).to(ctx.device) for x in inputs]
    _reset_k1()
    with torch.inference_mode():
        pos, rot = fn(*args)
    _synchronize(ctx)
    return {"pos": pos.float().cpu().numpy(), "rot": rot.float().cpu().numpy(),
            "batch_rows": (b0, b1), "stage": mesh.model_rank,
            "launches_by_route": dict(k1.launches_by_route)}


def pp_step(
    ctx: RankContext, data: int, pipe: int, model_cfg: dict, weights: dict[str, np.ndarray],
    batch: dict[str, np.ndarray], noise: Sequence[np.ndarray] | None, so3_kwargs: dict, *,
    n_microbatches: int, lr: float, dtype: str = "float32", steps: int = 1, seed: int = 0,
) -> dict[str, Any]:
    """``steps`` PP DSM steps (:func:`~se3diff_torch.training.dsm.
    pp_train_step`) on a ``data x pipe`` grid from full ``weights`` on the
    global ``batch``, with the train loop's defaults: step 0 with
    ``noise`` when it is given, each other step ``i`` with the noise that
    :func:`~se3diff_torch.training.dsm.draw_noise` draws on the global
    batch from a generator on the rank's device seeded ``seed + i``.
    Returns the global losses, the first step's clipped gradients and the
    weights after it of the parameters the rank holds a gradient of (its
    stage's layers and the replicated ones), the rank's stage and its K1
    forward launches by route and backward passes (in all and by backward
    route) in the first step."""
    mesh, model = _pp_model(ctx, data, pipe, model_cfg, weights, dtype)
    sdes, opt = _dsm_setup(ctx, model, weights, so3_kwargs, lr)
    fn = make_pp_score_fn(model, mesh, n_microbatches)
    b = _tensors(batch, ctx.device)
    losses, out = [], {}
    _reset_k1()
    for i in range(steps):
        if i == 0 and noise is not None:
            nz = DSMNoise(*(torch.as_tensor(x).to(ctx.device) for x in noise))
        else:
            nz = draw_noise(torch.Generator(device=ctx.device).manual_seed(seed + i), b, sdes)
        losses.append(float(pp_train_step(model, opt, b, nz, sdes, mesh, fn, lr=lr)))
        if i == 0:
            _synchronize(ctx)
            held = {n for n, p in model.named_parameters() if p.grad is not None}
            out = {"launches_by_route": dict(k1.launches_by_route),
                   "backward_calls": k1.backward_calls,
                   "backward_calls_by_route": dict(k1.backward_calls_by_route),
                   "grads": _numpy({n: p.grad for n, p in model.named_parameters() if n in held}),
                   "weights": _numpy({n: p for n, p in model.named_parameters() if n in held})}
    _synchronize(ctx)
    return {**out, "losses": losses, "stage": mesh.model_rank}
