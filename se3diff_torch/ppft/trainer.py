"""PPFT fine-tuning trainer: property-guided stochastic-control training.

Counterpart of ``se3diff_tpu/ppft/trainer.py`` (reference
`bioemu/src/bioemu/finetune.py`). A frozen score model (the base bundle)
and a small control net (``finetune_model``, same DiG architecture) record a
path with a ``*_finetune`` recorder; the control net is then re-forwarded
over the recorded path and gradients flow through the linearized importance
weight ``int <u, -dW>`` and the control cost ``int |u|^2 dt`` only
(SURVEY.md section 3.2).

The base model embeds its conditioning with the streamed pair bias
(``with_pa=True``); the control net embeds without it (``with_pa=False``),
as the JAX package's unfused path does, so every control-net attention runs
the IPA kernel's in-kernel pair-bias variant. The replay re-forwards the
control net one recorded step at a time under ``torch.utils.checkpoint``
(the counterpart of ``jax.checkpoint`` on the JAX scan body), with the
conditioning embedded once, with gradient. Everything is eager PyTorch.

Checkpoints are reference-layout state dicts in ``.npz``, the JAX package's
format: each package reads the other's.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from se3diff_torch.diffusion import denoise
from se3diff_torch.models.convert import load_checkpoint
from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights
from se3diff_torch.ppft.h_functions import H_FUNCTIONS
from se3diff_torch.ppft.losses import compute_ev_loss, compute_kl_loss
from se3diff_torch.ops.ipa_attention import check_card_widths
from se3diff_torch.sampling.bundle import Bundle, instantiate, load_bundle, read_config
from se3diff_torch.sampling.embeds import get_embeds, load_embeds
from se3diff_torch.sampling.seq_io import check_protein_valid
from se3diff_torch.training.loop import TrainConfig, make_schedule, step_generator

logger = logging.getLogger(__name__)

# h_func(pos [B, L, 3], sequence) -> [B, K]
HFunc = Callable[[torch.Tensor, str], torch.Tensor]


@dataclass
class FinetuneConfig:
    """Defaults = `bioemu/src/bioemu/config/finetune/finetune.yaml`."""

    # Data
    data_batch_size: int = 1
    shuffle: bool = True
    # Loss
    lambda_: float = 2.0e-05
    tol: float = 1.0e-07
    # Training
    batch_size: int = 256
    num_epochs: int = 4
    save_every_n_epochs: int = 2
    val_every_n_epochs: int = 4
    lr: float = 5.0e-04
    betas: tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    eta_min: float = 5.0e-06
    # Skip any update whose recorded-path KL estimate exceeds this many nats
    # (None: never); a trust region on the sampler, see the JAX trainer.
    kl_guard: float | None = None
    # When set, each training path refreshes {dir}/batch_*.npz, topology.pdb
    # and samples.xtc with its endpoint batch (finetune.py:419-448, gated).
    debug_dump_dir: str | None = None


class FinetuneBundle(NamedTuple):
    """(finetune.py:94-99): the frozen score model rides inside ``base``;
    the control net holds its own parameters."""

    base: Bundle
    finetune_model: DiGConditionalScoreModel
    denoiser: Callable  # a partial of a *_finetune recorder
    h_func: HFunc


FINETUNE_DENOISERS = {
    # config/denoiser/{heun,euler_maruyama}_finetune.yaml and sde_dpm_finetune.yaml
    "heun_finetune": dict(
        fn=denoise.heun_finetune, num_steps=100, max_t=0.99, min_t=0.001, noise=0.5
    ),
    "euler_maruyama_finetune": dict(
        fn=denoise.euler_maruyama_finetune, num_steps=200, max_t=0.99, min_t=0.001
    ),
    "sde_dpm_solver_finetune": dict(
        fn=denoise.sde_dpm_solver_finetune, num_steps=50, max_t=0.99, min_t=0.001
    ),
}


def load_finetune_bundle(
    ckpt_path: str | os.PathLike,
    model_config_path: str | os.PathLike | None = None,
    finetune_ckpt_path: str | os.PathLike | None = None,
    denoiser_type: str = "heun_finetune",
    h_func: HFunc | str = "folding_stability",
    h_func_kwargs: dict | None = None,
    so3_cache_dir: str | None = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> FinetuneBundle:
    """Score model (frozen, in ``dtype``) and control net (f32, weights from
    ``seed`` or ``finetune_ckpt_path``) and the finetune recorder
    (finetune.py:125-196), on ``device``."""
    config = read_config(ckpt_path, model_config_path)
    if "finetune_model" not in config:
        raise ValueError("model config must contain 'finetune_model'")
    # load_bundle checks the score model's widths; the control net's here,
    # both before the device is resolved.
    check_card_widths(config["finetune_model"], device)
    base = load_bundle(
        ckpt_path, config_path=model_config_path, so3_cache_dir=so3_cache_dir, dtype=dtype,
        device=device,
    )
    base.model.requires_grad_(False)

    ft_model: DiGConditionalScoreModel = instantiate(dict(base.config["finetune_model"]))
    init_weights(ft_model, torch.Generator().manual_seed(seed))
    if finetune_ckpt_path is not None:
        ft_model.load_state_dict(load_finetune_params(finetune_ckpt_path), strict=True)
    # Dropout stays off, as in the JAX package's deterministic apply.
    ft_model.to(base.device).eval()

    dn = dict(FINETUNE_DENOISERS[denoiser_type])
    denoiser = partial(dn.pop("fn"), **dn)
    if isinstance(h_func, str):
        h_func = H_FUNCTIONS[h_func](**(h_func_kwargs or {}))
    return FinetuneBundle(base=base, finetune_model=ft_model, denoiser=denoiser, h_func=h_func)


def load_finetune_params(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """A control-net state dict from ``.npz`` (either package's) or ``.pt``."""
    return load_checkpoint(str(path))


def save_finetune_params(state: dict[str, torch.Tensor], path: str | os.PathLike) -> None:
    """A control-net state dict as ``.npz`` in the reference layout."""
    np.savez(path, **{k: v.detach().float().cpu().numpy() for k, v in state.items()})


# --------------------------------------------------------------------- #
# Dataset                                                                 #
# --------------------------------------------------------------------- #


class SequenceHStarsDataset:
    """CSV -> (sequence, h_stars [K]) rows (finetune.py:199-262). With
    ``from_dg`` the columns are free energies and the targets are
    ``sigmoid(-dg)`` (observables.py:457-480)."""

    def __init__(self, csv_path, sequence_col: str, h_stars_cols: str | list[str],
                 from_dg: bool = False):
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
            columns = reader.fieldnames or []
        if isinstance(h_stars_cols, str):
            h_stars_cols = [h_stars_cols]
        missing = [c for c in [sequence_col, *h_stars_cols] if c not in columns]
        if missing:
            raise ValueError(f"columns not found in CSV: {missing}")
        self.sequences = [r[sequence_col] for r in rows]
        h_stars = np.array(
            [[float(r[c]) for c in h_stars_cols] for r in rows], np.float64
        ).reshape(len(rows), len(h_stars_cols))
        if from_dg:
            h_stars = 1.0 / (1.0 + np.exp(h_stars))
        self.h_stars = h_stars.astype(np.float32)

    def __len__(self) -> int:
        return len(self.sequences)

    def __getitem__(self, idx: int) -> tuple[str, np.ndarray]:
        return self.sequences[idx], self.h_stars[idx]

    def batches(
        self, batch_size: int = 1, shuffle: bool = True, rng: np.random.Generator | None = None
    ) -> Iterator[list[tuple[str, np.ndarray]]]:
        order = np.arange(len(self))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for start in range(0, len(order), batch_size):
            yield [self[int(i)] for i in order[start : start + batch_size]]


# --------------------------------------------------------------------- #
# Path generation + loss                                                  #
# --------------------------------------------------------------------- #


def _finetune_model_fn(bundle: FinetuneBundle, single, pair, batch: int):
    """Per-step control-net fn with the conditioning embedded once, without
    the streamed pair bias. Under autograd the embed is recorded once and
    every step's gradient flows back through it."""
    model = bundle.finetune_model
    s = single.expand(batch, *single.shape)
    p = pair.expand(batch, *pair.shape)
    cache = model.embed_conditioning(s, p, with_pa=False)

    def fn(pos, rot, t):
        return model.score_from_cache(pos, rot, t, cache)

    return fn


def make_path_sampler(bundle: FinetuneBundle, batch_size: int, length: int):
    """``sampler(generator, single [L, 384], pair [L, L, 128]) ->
    DenoisedSDEPath``: one recorded batch, without gradients. Both models
    embed their conditioning once; the recorder replays only the per-step
    score evaluations."""

    @torch.no_grad()
    def sampler(generator: torch.Generator, single, pair) -> denoise.DenoisedSDEPath:
        base = bundle.base.model
        base_cache = base.embed_conditioning(
            single.expand(batch_size, *single.shape), pair.expand(batch_size, *pair.shape)
        )

        def model_fn(pos, rot, t):
            return base.score_from_cache(pos, rot, t, base_cache)

        ft_fn = _finetune_model_fn(bundle, single, pair, batch_size)
        return bundle.denoiser(
            generator, bundle.base.sdes, model_fn, ft_fn, batch=batch_size, length=length
        )

    return sampler


def generate_finetune_batch(
    generator: torch.Generator, bundle: FinetuneBundle, single, pair, batch_size: int
) -> denoise.DenoisedSDEPath:
    """One recorded sampling batch (finetune.py:291-335)."""
    return make_path_sampler(bundle, batch_size, single.shape[0])(generator, single, pair)


def _int_uudt_from_us(us: dict[str, torch.Tensor], dts: torch.Tensor) -> torch.Tensor:
    """Full-path control cost ``int |u|^2 (-dt)`` per sample [B]."""
    return sum(
        (u.square().sum((-1, -2)) * (-dts)[:, None]).sum(0) for u in us.values()
    )


def path_kl(path: denoise.DenoisedSDEPath) -> float:
    """Raw KL-control-cost estimate of a recorded path (nats, ws = 1), the
    quantity ``kl_guard`` bounds."""
    int_uudt = _int_uudt_from_us(path.us, torch.diff(path.timesteps))
    ws = torch.ones_like(int_uudt)
    return float(compute_kl_loss(
        ws=ws, int_u_u_dt=int_uudt, int_u_u_dt_sg=int_uudt, from_int_dws=False, use_rloo=False,
    ))


def make_finetune_step_fns(
    bundle: FinetuneBundle, lambda_: float = 2.0e-05, tol: float = 1.0e-07
):
    """``(grad_fn, val_fn)`` for this bundle (finetune.py:396-514).

    ``grad_fn(path, single, pair, hs, h_stars) -> (grads, val_loss)``
    re-forwards the control net over the recorded path, one checkpointed
    step at a time, and returns the gradient of ``EV + lambda KL`` for every
    parameter (a dict by name) and the validation loss. ``val_fn(path, hs,
    h_stars) -> val_loss`` is the reference's validation quantity (ws = 1,
    raw EV + lambda KL from the recorded controls).
    """
    model = bundle.finetune_model

    def val_fn(path, hs, h_stars) -> torch.Tensor:
        int_uudt_sg = _int_uudt_from_us(path.us, torch.diff(path.timesteps))
        ws = torch.ones_like(int_uudt_sg)
        val_ev = compute_ev_loss(
            ws=ws, hs=hs, h_stars=h_stars, from_int_dws=False, use_stab=False, tol=tol
        )
        val_kl = compute_kl_loss(
            ws=ws, int_u_u_dt=int_uudt_sg, int_u_u_dt_sg=int_uudt_sg,
            from_int_dws=False, use_rloo=False,
        )
        return val_ev + lambda_ * val_kl

    def grad_fn(path, single, pair, hs, h_stars):
        dts = torch.diff(path.timesteps)  # [T], negative (reverse time)
        int_uudt_sg = _int_uudt_from_us(path.us, dts)
        B = path.pos_path.shape[1]
        params = dict(model.named_parameters())
        with torch.enable_grad():
            ft_fn = _finetune_model_fn(bundle, single, pair, B)

            def step(pos_t, rot_t, t, dW_pos, dW_rot, dt):
                u_pos, u_rot = ft_fn(pos_t, rot_t, t)
                dws = (u_pos * -dW_pos).sum((-1, -2)) + (u_rot * -dW_rot).sum((-1, -2))
                uudt = (u_pos.square().sum((-1, -2)) + u_rot.square().sum((-1, -2))) * (-dt)
                return dws, uudt

            int_dws = torch.zeros(B, device=dts.device)
            int_uudt = torch.zeros(B, device=dts.device)
            for k in range(dts.shape[0]):
                t = path.timesteps[k].expand(B)
                dws, uudt = checkpoint(
                    step, path.pos_path[k], path.rot_path[k], t, path.dWs["pos"][k],
                    path.dWs["node_orientations"][k], dts[k], use_reentrant=False,
                )
                int_dws = int_dws + dws
                int_uudt = int_uudt + uudt
            loss_ev = compute_ev_loss(
                ws=int_dws, hs=hs, h_stars=h_stars, from_int_dws=True, use_stab=True, tol=tol
            )
            loss_kl = compute_kl_loss(
                ws=int_dws, int_u_u_dt=int_uudt, int_u_u_dt_sg=int_uudt_sg,
                from_int_dws=True, use_rloo=True,
            )
            loss = loss_ev + lambda_ * loss_kl
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {
            name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(params.items(), grads)
        }
        return grads, val_fn(path, hs, h_stars)

    return grad_fn, val_fn


# --------------------------------------------------------------------- #
# Training loop                                                           #
# --------------------------------------------------------------------- #


def _dump_terminal_batch(dump_dir: Path, seq: str, pos: torch.Tensor, rot: torch.Tensor) -> None:
    """Refresh ``dump_dir`` with a path's endpoint batch: ``batch_*.npz``
    (reference npz keys), topology.pdb and samples.xtc, unfiltered
    (finetune.py:419-448)."""
    from se3diff_torch.sampling.pipeline import (
        _append_centered, _write_ensemble, format_npz_samples_filename,
    )
    from se3diff_torch.struct.atoms import atom37_from_frames, atom37_mask
    from se3diff_torch.struct.residues import sequence_to_aatype

    dump_dir.mkdir(parents=True, exist_ok=True)
    B = pos.shape[0]
    np.savez(
        dump_dir / format_npz_samples_filename(0, B),
        pos=pos.cpu().numpy(), node_orientations=rot.cpu().numpy(), sequence=seq,
    )
    aatype = sequence_to_aatype(seq)
    mask = atom37_mask(aatype)
    atom37, _ = atom37_from_frames(pos, rot, aatype)
    chunks: list = []
    _append_centered(chunks, atom37.cpu().numpy(), mask)
    _write_ensemble(dump_dir, seq, aatype, mask, chunks, B, filter_samples=False)


def finetune(
    csv_path: str | os.PathLike,
    csv_path_val: str | os.PathLike,
    sequence_col: str,
    h_stars_cols: str | list[str],
    bundle: FinetuneBundle,
    config: FinetuneConfig = FinetuneConfig(),
    output_dir: str | os.PathLike = "finetune_out",
    cache_embeds_dir: str | None = None,
    embeds_backend: str = "colabfold",
    msa_file: str | os.PathLike | None = None,
    msa_host_url: str | None = None,
    seed: int = 0,
    h_stars_from_dg: bool = False,
) -> dict[str, torch.Tensor]:
    """The fine-tuning loop (finetune.py:517-692), on the bundle's device.
    ``h_stars_from_dg``: the h* columns hold free energies (see
    ``SequenceHStarsDataset``).

    Epoch 0 is validation only; AdamW with a cosine decay to ``eta_min``
    over all updates; checkpoints ``finetune_model_{epoch}.npz`` every
    ``save_every_n_epochs`` and at the end, the best-validation weights as
    ``finetune_model.npz``, ``history.json`` after every epoch (each entry
    with its host wall, ``seconds``: the losses are read back on the host
    after every path, so the wall covers the device work). A path whose
    KL exceeds ``kl_guard`` is not replayed and adds nothing to the update.
    Returns the best state dict. Path ``k`` of the run draws its noise from
    the generator of ``(seed, k)``.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model, device = bundle.finetune_model, bundle.base.device

    dataset = SequenceHStarsDataset(csv_path, sequence_col, h_stars_cols, h_stars_from_dg)
    dataset_val = SequenceHStarsDataset(csv_path_val, sequence_col, h_stars_cols, h_stars_from_dg)
    num_batches = -(-len(dataset) // config.data_batch_size)
    schedule = make_schedule(TrainConfig(
        num_steps=max(config.num_epochs * num_batches, 1), lr=config.lr,
        eta_min_ratio=config.eta_min / config.lr,
    ))
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=config.lr, betas=tuple(config.betas), eps=1e-8,
        weight_decay=config.weight_decay,
    )
    updates = 0

    rng = np.random.default_rng(seed)
    paths = 0
    embeds: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def embeds_for(seq: str):
        # With msa_file set, every mutant reuses the wild-type MSA (query row
        # swapped per sequence inside get_embeds), as finetune.py:299-322.
        if seq not in embeds:
            check_protein_valid(seq)
            sf, pf = get_embeds(
                seq, cache_embeds_dir, backend=embeds_backend, msa_file=msa_file,
                msa_host_url=msa_host_url,
            )
            single, pair = load_embeds(sf, pf)
            embeds[seq] = tuple(
                torch.from_numpy(np.array(x, np.float32)).to(device) for x in (single, pair)
            )
        return embeds[seq]

    grad_fn, val_fn = make_finetune_step_fns(bundle, config.lambda_, config.tol)
    samplers: dict[int, Callable] = {}

    def run_one(seq, h_stars, for_grad):
        nonlocal paths
        single, pair = embeds_for(seq)
        L = single.shape[0]
        if L not in samplers:
            samplers[L] = make_path_sampler(bundle, config.batch_size, L)
        path = samplers[L](step_generator(seed, paths, device), single, pair)
        paths += 1
        with torch.no_grad():
            hs = bundle.h_func(path.pos_path[-1], seq)
        if config.debug_dump_dir and for_grad:
            _dump_terminal_batch(
                Path(config.debug_dump_dir), seq, path.pos_path[-1], path.rot_path[-1]
            )
        kl = path_kl(path)
        h_stars = torch.as_tensor(h_stars, device=device)
        if not for_grad:
            return None, float(val_fn(path, hs, h_stars)), kl
        if config.kl_guard is not None and kl > config.kl_guard:
            return None, None, kl
        grads, loss = grad_fn(path, single, pair, hs, h_stars)
        return grads, float(loss), kl

    best_val, best_epoch = float("inf"), 0
    best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    history: dict = {"train": [], "val": [], "config": dataclasses.asdict(config)}

    def _write_history():
        history["best_epoch"] = best_epoch
        history["best_val"] = best_val
        with open(output_dir / "history.json", "w") as f:
            json.dump(history, f, indent=1)

    for epoch in range(config.num_epochs + 1):
        if epoch > 0:
            t0 = time.perf_counter()
            epoch_loss, n, kls, skipped = 0.0, 0, [], 0
            for data_batch in dataset.batches(config.data_batch_size, config.shuffle, rng):
                grads_sum = None
                for seq, h_stars in data_batch:
                    grads, loss, kl = run_one(seq, h_stars, True)
                    kls.append(kl)
                    if grads is None:
                        # Trust region: the linearized importance weights
                        # behind this path are degenerate; drop it.
                        skipped += 1
                        logger.info("kl_guard: skipping update (path KL %.1f > %.1f)",
                                    kl, config.kl_guard)
                        continue
                    grads_sum = grads if grads_sum is None else {
                        k: grads_sum[k] + g for k, g in grads.items()
                    }
                    epoch_loss += loss
                    n += 1
                if grads_sum is not None:
                    for name, p in model.named_parameters():
                        p.grad = grads_sum[name]
                    for group in optimizer.param_groups:
                        group["lr"] = schedule(updates)
                    optimizer.step()
                    optimizer.zero_grad(set_to_none=True)
                    updates += 1
            logger.info("Epoch %d: avg train loss %.4f", epoch, epoch_loss / max(n, 1))
            history["train"].append({
                "epoch": epoch,
                "loss": epoch_loss / max(n, 1),
                "mean_path_kl": float(np.mean(kls)) if kls else 0.0,
                "max_path_kl": float(np.max(kls)) if kls else 0.0,
                "skipped_updates": skipped,
                "seconds": time.perf_counter() - t0,
            })

        if epoch % config.val_every_n_epochs == 0 or epoch == config.num_epochs:
            t0 = time.perf_counter()
            val_loss, val_kl, n = 0.0, 0.0, 0
            for (seq, h_stars), in dataset_val.batches(1, shuffle=False):
                _, loss, kl = run_one(seq, h_stars, False)
                val_loss += loss
                val_kl += kl
                n += 1
            avg_val = val_loss / max(n, 1)
            logger.info("Epoch %d: avg val loss %.4f", epoch, avg_val)
            history["val"].append({
                "epoch": epoch, "val_loss": avg_val, "val_path_kl": val_kl / max(n, 1),
                "seconds": time.perf_counter() - t0,
            })
            if avg_val < best_val:
                best_val, best_epoch = avg_val, epoch
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
                logger.info("Updated best model at epoch %d", epoch)

        if epoch % config.save_every_n_epochs == 0 or epoch == config.num_epochs:
            save_finetune_params(model.state_dict(), output_dir / f"finetune_model_{epoch}.npz")
        _write_history()

    save_finetune_params(best_state, output_dir / "finetune_model.npz")
    return best_state
