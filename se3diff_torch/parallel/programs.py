"""Rank programs for :func:`~se3diff_torch.parallel.launch.run_ranks`.

Each takes the rank's :class:`~se3diff_torch.parallel.mesh.RankContext` and
picklable arguments (numpy arrays, plain values), builds what it needs on
the rank's device and returns numpy or plain values. They drive the
sequence-parallel (SP) score network, the SP sampling pipeline and
data-parallel (DP) sampling, and are what the test suite and
``chip_smoke.py`` run on each rank to hold the multi-rank paths against one
process.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights
from se3diff_torch.ops import ipa_attention as k1
from se3diff_torch.parallel.mesh import RankContext
from se3diff_torch.parallel.sample import sample_batch_sharded
from se3diff_torch.sampling.bundle import random_bundle
from se3diff_torch.sampling.pipeline import sample


def in_turn(ctx: RankContext, steps: Sequence[tuple[Callable, tuple]]) -> list[Any]:
    """Run several programs ``(fn, args)`` on one rank, in order, in one
    group: one spawn for all of them."""
    return [fn(ctx, *args) for fn, args in steps]


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
    k1.check_card_widths(model_cfg, ctx.device)
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
    k1.launches = 0
    k1.launches_by_route.update(dict.fromkeys(k1.launches_by_route, 0))
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
