"""DSM training loop with checkpoints and exact resume.

Counterpart of ``se3diff_tpu/training/loop.py``: warmup + cosine learning
rate equal to optax's schedules step for step, AdamW with optax's global-norm
clipping, periodic validation, ``train_log.jsonl`` metrics lines, and
checkpoints of ``{model, optimizer, step}`` as torch files in place of orbax.
The per-step generator is seeded from ``(seed, step)``, so a resumed run
draws the same noise as an uninterrupted one and ends with the same weights.

With a ``mesh`` (:class:`~se3diff_torch.parallel.mesh.MeshContext`) every
rank runs this loop on the model's shard, through
:func:`~se3diff_torch.training.dsm.mesh_train_step` (the JAX loop's
``mesh=`` path, ``se3diff_tpu/training/loop.py:110-136``). Every rank draws
the global batch's noise from the step's generator. A checkpoint holds the
full model and the full AdamW moments, gathered over the model group, in
the one-device layout, written by rank 0 behind a barrier; a resume loads
the full state on every rank and shards it, so a mesh checkpoint and a
one-device one are the same file.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from functools import partial
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from se3diff_torch.diffusion.denoise import SDEs
from se3diff_torch.parallel.mesh import MeshContext
from se3diff_torch.parallel.sharding import gather_state_dict, shard_state_dict
from se3diff_torch.training.dsm import draw_noise, dsm_loss, mesh_train_step, train_step

logger = logging.getLogger(__name__)

# Step index of the validation noise: one no training step uses.
_VAL_STEP = 2**32 - 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters (the JAX package's defaults: AdamW + cosine)."""

    num_steps: int = 1000
    lr: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 0
    eta_min_ratio: float = 0.01  # cosine floor as a fraction of lr
    grad_clip: float | None = 1.0
    ckpt_every: int = 0          # 0 = no checkpointing
    ckpt_dir: str | None = None
    max_ckpts_kept: int = 3
    val_every: int = 0           # 0 = no validation
    log_every: int = 50
    min_t: float = 0.001
    seed: int = 0
    # One JSON line per log_every step (step, loss, lr, seconds). Defaults to
    # {ckpt_dir}/train_log.jsonl when checkpointing.
    metrics_path: str | None = None


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Learning rate at optimizer count ``c`` (the update at step ``c`` uses
    ``sched(c)``): optax's ``warmup_cosine_decay_schedule`` from 0 to ``lr``
    over ``warmup_steps``, then cosine to ``lr * eta_min_ratio`` at
    ``num_steps``; ``cosine_decay_schedule`` without warmup."""
    decay_steps = max(cfg.num_steps, 1)
    alpha = cfg.eta_min_ratio

    def cosine(count: float, init: float, steps: int) -> float:
        count = min(count, steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / steps)) + alpha)

    if cfg.warmup_steps <= 0:
        return lambda c: cosine(c, cfg.lr, decay_steps)
    warmup = cfg.warmup_steps
    if decay_steps - warmup <= 0:
        raise ValueError(f"num_steps ({cfg.num_steps}) must exceed warmup_steps ({warmup})")

    def sched(c: int) -> float:
        if c < warmup:
            return cfg.lr * c / warmup
        return cosine(c - warmup, cfg.lr, decay_steps - warmup)

    return sched


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay
    ``cfg.weight_decay``); the learning rate is set before each step."""
    return torch.optim.AdamW(
        params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay
    )


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of step ``step``, a function of ``(seed, step)`` alone."""
    state = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


def _to_device(batch: dict, device: torch.device) -> dict:
    return {
        k: v.to(device) if isinstance(v, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items()
    }


def _checkpoints(ckpt_dir: str) -> list[tuple[int, Path]]:
    found = [(int(p.stem.split("_")[1]), p) for p in Path(ckpt_dir).glob("step_*.pt")]
    return sorted(found)


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _map_moments(model, optimizer_state: dict, fn: Callable[[dict], dict]) -> dict:
    """``optimizer_state`` (an AdamW state dict) with its moments replaced:
    each moment's ``{parameter name: tensor}`` dict through ``fn``."""
    names = [n for n, _ in model.named_parameters()]
    state = {i: dict(s) for i, s in optimizer_state["state"].items()}
    for key in _MOMENTS:
        mapped = fn({names[i]: s[key] for i, s in state.items()})
        for i, s in state.items():
            s[key] = mapped[names[i]]
    return {**optimizer_state, "state": state}


def _full_state(model, optimizer, mesh: MeshContext | None) -> tuple[dict, dict]:
    """The full model's and the full optimizer's state dicts: the rank's own
    without a model axis, else gathered over the model group (every rank of
    it must call this)."""
    model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    if mesh is None or mesh.tp is None:
        return model_sd, opt_sd
    gather = partial(gather_state_dict, group=mesh.model_group)
    return gather(model_sd), _map_moments(model, opt_sd, gather)


def _load_state(model, optimizer, state: dict, mesh: MeshContext | None) -> None:
    """Load a full checkpoint, sharded to the rank under a model axis."""
    model_sd, opt_sd = state["model"], state["optimizer"]
    if mesh is not None and mesh.tp is not None:
        shard = partial(shard_state_dict, model_rank=mesh.model_rank, model=mesh.model)
        model_sd, opt_sd = shard(model_sd), _map_moments(model, opt_sd, shard)
    model.load_state_dict(model_sd)
    optimizer.load_state_dict(opt_sd)


def _save_checkpoint(cfg: TrainConfig, step: int, model, optimizer,
                     mesh: MeshContext | None = None) -> None:
    model_sd, opt_sd = _full_state(model, optimizer, mesh)
    if mesh is None or mesh.rank == 0:
        d = Path(cfg.ckpt_dir)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"step_{step:08d}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({"model": model_sd, "optimizer": opt_sd, "step": step}, tmp)
        os.replace(tmp, path)  # a checkpoint on disk is a whole one
        for _, old in _checkpoints(cfg.ckpt_dir)[:-cfg.max_ckpts_kept]:
            old.unlink()
    if mesh is not None:  # no rank reads the directory while rank 0 writes it
        dist.barrier()


def train_dsm(
    sdes: SDEs,
    model: torch.nn.Module,
    batch_fn: Callable[[int], dict],
    cfg: TrainConfig,
    val_batch: dict | None = None,
    mesh: MeshContext | None = None,
) -> tuple[torch.nn.Module, list[float]]:
    """Run ``cfg.num_steps`` DSM steps on the model's device; returns
    ``(model, loss_history)``, the model trained in place.

    ``batch_fn`` maps a step index to its batch, which is what lets a
    resumed run re-derive the batches it missed. With ``ckpt_every`` and
    ``ckpt_dir`` set, the latest checkpoint there is restored first and the
    steps it covers are skipped. With ``mesh``, ``model`` is the rank's shard
    (built with ``tp=mesh.tp``), ``batch_fn`` gives the global batch, every
    rank of the mesh runs this together, and rank 0 alone writes the
    checkpoints and the metrics; the loss history is the global loss's.
    """
    device = next(model.parameters()).device
    optimizer = make_optimizer(cfg, model.parameters())
    sched = make_schedule(cfg)

    start_step = 0
    checkpointing = bool(cfg.ckpt_every and cfg.ckpt_dir)
    if checkpointing and _checkpoints(cfg.ckpt_dir):
        _, path = _checkpoints(cfg.ckpt_dir)[-1]
        state = torch.load(path, map_location=device, weights_only=True)
        _load_state(model, optimizer, state, mesh)
        start_step = state["step"]
        logger.info("resumed from checkpoint at step %d", start_step)

    metrics_path = cfg.metrics_path or (
        os.path.join(cfg.ckpt_dir, "train_log.jsonl") if checkpointing else None
    )
    writer = mesh is None or mesh.rank == 0
    metrics_f = None
    if metrics_path and writer:
        os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)
        metrics_f = open(metrics_path, "a")  # appended across resumes
    t_start = time.perf_counter()

    history: list[float] = []
    loss = None
    try:
        for step in range(start_step, cfg.num_steps):
            batch = _to_device(batch_fn(step), device)
            gen = step_generator(cfg.seed, step, device)
            if mesh is None:
                loss = train_step(model, optimizer, batch, gen, sdes, lr=sched(step),
                                  min_t=cfg.min_t, grad_clip=cfg.grad_clip)
            else:
                loss = mesh_train_step(
                    model, optimizer, batch, draw_noise(gen, batch, sdes, cfg.min_t), sdes, mesh,
                    lr=sched(step), grad_clip=cfg.grad_clip,
                )
            if cfg.log_every and (step + 1) % cfg.log_every == 0:
                loss_f = float(loss)
                history.append(loss_f)
                if writer:
                    logger.info("step %d: dsm loss %.5f", step + 1, loss_f)
                if metrics_f is not None:
                    metrics_f.write(json.dumps({
                        "step": step + 1, "loss": loss_f, "lr": sched(step),
                        "seconds": round(time.perf_counter() - t_start, 3),
                    }) + "\n")
                    metrics_f.flush()
            if val_batch is not None and cfg.val_every and (step + 1) % cfg.val_every == 0:
                vb = _to_device(val_batch, device)
                with torch.no_grad():
                    noise = draw_noise(step_generator(cfg.seed, _VAL_STEP, device), vb, sdes, cfg.min_t)
                    vl = float(dsm_loss(model, vb, noise, sdes))
                if writer:
                    logger.info("step %d: val dsm loss %.5f", step + 1, vl)
            if checkpointing and (step + 1) % cfg.ckpt_every == 0:
                _save_checkpoint(cfg, step + 1, model, optimizer, mesh)
    finally:
        if metrics_f is not None:
            metrics_f.close()
    if not history and loss is not None:
        history.append(float(loss))
    return model, history
