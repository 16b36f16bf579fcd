"""Pretrain an SH3 prior with the PyTorch port, for the PPFT learning run.

The port's counterpart of ``scripts/pretrain_sh3_prior.py``, with its flags
and defaults (``--device`` in place of ``--platform``). PPFT learns only
from a prior whose samples land inside FoldingStability's sigmoid: a
random-init prior gives coil, h saturates at its clamp and the EV term has
no gradient. So this script trains a stand-in prior with the port's DSM
trainer (``se3diff_torch.training.loop.train_dsm``):

* Data: a synthetic frame-space ensemble around the real 2vwf SH3 backbone
  (``assets/structures/2vwf_trimmed_SH3.pdb``): per conformer, CA
  translations get iid Gaussian noise with sigma uniform in [0.15, 0.42] nm
  and the residue frames a proportional rotvec kick, so the ensemble's h
  spans (0, 1). The draws are the JAX script's, number for number (numpy's
  ``default_rng(seed + 1)``).
* Conditioning: dummy-backend embeddings of exactly the mutant sequences
  the learning run visits (same CSV, seed and split), each staged on the
  device once (``MultiEnsembleDataset.batch_fn``).
* Model: the production DiG (bioemu-v1.0 widths, 31.28M parameters, f32
  parameters, bf16 compute), the base that ``torch_ppft_trainer_run.py``
  freezes.

Writes ``{ckpt_dir}/params.npz`` (the reference key layout, which both
packages load) and, with ``--output``, a JSON artifact with the loss
history. A cut run resumes from the checkpoints in ``--ckpt_dir``. Then it
samples ``--sample_check`` wild-type structures with DPM-Solver-30 and
reports their h distribution.

    python scripts/torch_pretrain_sh3_prior.py --ckpt_dir /tmp/sh3_prior \\
        --output /tmp/sh3_prior_train.json          # on the card
    python scripts/torch_pretrain_sh3_prior.py --tiny --device cpu   # smoke
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

GRB2_CSV = REPO / "assets" / "reference_h" / "GRB2_SH3_high_confidence.csv"
EMBEDS_CACHE = REPO / ".embeds_cache_ppft"
H_QUANTILES = [0.05, 0.25, 0.5, 0.75, 0.95]
# Steps left out of the median step wall (allocator, library loads).
WARMUP_STEPS = 10


def read_csv_rows(path) -> list[dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def mutant_sequences(csv_path, seed: int, val_size: int, train_steps: int) -> list[str]:
    """The sequences the learning run visits: its validation split plus the
    first ``train_steps`` training mutants, under the same permutation."""
    seqs = [r["seq"] for r in read_csv_rows(csv_path)]
    order = np.random.default_rng(seed).permutation(len(seqs))
    val_idx, train_idx = order[:val_size], order[val_size:]
    visit = list(val_idx) + [train_idx[i % len(train_idx)] for i in range(train_steps)]
    seen, out = set(), []
    for i in visit:
        if seqs[i] not in seen:
            seen.add(seqs[i])
            out.append(seqs[i])
    return out


def make_ensemble(ref_pos, ref_rot, frames: int, rng, sigma_lo: float, sigma_hi: float):
    """Perturbed rigid frames around the reference: iid CA noise with a
    per-conformer sigma (uniform in [lo, hi] nm) plus a proportional random
    rotvec on each residue frame."""
    import torch

    from se3diff_torch.ops.so3 import rotvec_to_rotmat

    L = ref_pos.shape[0]
    sig = rng.uniform(sigma_lo, sigma_hi, size=(frames, 1, 1))
    pos = ref_pos[None] + rng.standard_normal((frames, L, 3)) * sig
    pos = (pos - pos.mean(axis=1, keepdims=True)).astype(np.float32)
    # Rotation kick: angle scale ~1.5 rad at sigma_hi, proportional below.
    ang = rng.standard_normal((frames, L, 3)) * (sig * 3.5)
    dR = rotvec_to_rotmat(torch.from_numpy(ang.astype(np.float32))).numpy()
    rot = np.einsum("flij,fljk->flik", dR, np.broadcast_to(ref_rot[None], dR.shape)).astype(np.float32)
    return pos, rot


def h_summary(h: np.ndarray) -> dict:
    return {"mean": float(h.mean()),
            "quantiles": [round(float(q), 4) for q in np.quantile(h, H_QUANTILES)]}


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    import torch

    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=256, help="ensemble conformers per mutant sequence")
    p.add_argument("--sigma_lo", type=float, default=0.15)
    p.add_argument("--sigma_hi", type=float, default=0.42)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup_steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0,
                   help="must match the learning run's --seed (split logic)")
    p.add_argument("--val_size", type=int, default=4)
    p.add_argument("--covered_steps", type=int, default=60,
                   help="learning-run optimizer steps whose mutants to cover")
    p.add_argument("--csv", default=str(GRB2_CSV))
    p.add_argument("--ckpt_dir", default="/tmp/sh3_prior")
    p.add_argument("--output", default=None, help="JSON artifact path")
    p.add_argument("--sample_check", type=int, default=64,
                   help="post-train: sample this many WT structures and report their h "
                        "distribution (0 = skip)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.tiny:
        args.steps = min(args.steps, 6)
        args.batch = 4
        args.frames = 16
        args.covered_steps = 2
        args.val_size = 1
        args.sample_check = min(args.sample_check, 4)
        args.warmup_steps = 2
    return args


def main(argv=None):
    """Run the pretraining; returns ``(model, summary)``, the model trained."""
    args = parse_args(argv)

    import torch

    from se3diff_torch.diffusion import denoise
    from se3diff_torch.models.dig import DiGConditionalScoreModel, count_params, init_weights
    from se3diff_torch.ops.ipa_attention import check_card_widths
    from se3diff_torch.ppft.h_functions import DEFAULT_SH3_REF, compute_folded_proportion
    from se3diff_torch.sampling.bundle import Bundle, resolve_device
    from se3diff_torch.sampling.embeds import get_embeds, load_embeds
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.struct.atoms import frames_from_atom37
    from se3diff_torch.struct.pdb import read_pdb
    from se3diff_torch.training.data import EnsembleDataset, MultiEnsembleDataset
    from se3diff_torch.training.loop import TrainConfig, train_dsm

    model_kw = (dict(num_layers=1, dim_model=16, dim_pair=8, num_heads=2, dim_hidden=16, dropout=0.0)
                if args.tiny else dict(dtype=torch.bfloat16))
    check_card_widths(model_kw, args.device, model_kw.get("dtype", torch.float32))
    device = resolve_device(args.device)

    # Reference frames from the real SH3 backbone; CA positions are the
    # frame translations (nm).
    ref_pos, ref_rot = frames_from_atom37(read_pdb(DEFAULT_SH3_REF).atom37[0])
    ref_pos = (ref_pos - ref_pos.mean(0, keepdims=True)).astype(np.float32)
    ref_ca = torch.from_numpy(ref_pos)
    L = ref_pos.shape[0]

    seqs = mutant_sequences(args.csv, args.seed, args.val_size, args.covered_steps)
    if any(len(s) != L for s in seqs):
        raise ValueError(f"{args.csv}: a mutant's length differs from the reference's {L}")
    print(f"{len(seqs)} mutant sequences, L={L}", file=sys.stderr)

    rng = np.random.default_rng(args.seed + 1)
    datasets, h_all = [], []
    for seq in seqs:
        pos, rot = make_ensemble(ref_pos, ref_rot, args.frames, rng, args.sigma_lo, args.sigma_hi)
        single, pair = load_embeds(*get_embeds(seq, str(EMBEDS_CACHE), backend="dummy"))
        datasets.append(EnsembleDataset(
            pos=pos, rot=rot, single=np.asarray(single, np.float32),
            pair=np.asarray(pair, np.float32), sequence=seq,
        ))
        h_all.append(compute_folded_proportion(torch.from_numpy(pos), ref_ca).numpy())
    data_h = h_summary(np.concatenate(h_all))
    print(f"ensemble h: mean={data_h['mean']:.3f} q={data_h['quantiles']}", file=sys.stderr)

    # Each mutant's conditioning goes to the device once; a step copies its
    # frame batch alone.
    batch_fn = MultiEnsembleDataset(datasets=tuple(datasets), bucket=L).batch_fn(
        args.batch, seed=args.seed, device=device)
    step_starts: list[float] = []

    def timed_batch_fn(step: int) -> dict:
        # Called once at the start of each step: the gaps are step walls.
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_starts.append(time.perf_counter())
        return batch_fn(step)

    model = DiGConditionalScoreModel(**model_kw)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    n_params = count_params(model)
    print(f"score net: {n_params / 1e6:.1f}M params", file=sys.stderr)
    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(sigma_max=2.33, device=device))

    cfg = TrainConfig(
        num_steps=args.steps, lr=args.lr, warmup_steps=args.warmup_steps,
        min_t=0.05 if args.tiny else 0.001,  # tiny tables: igso3 validity
        ckpt_every=500 if args.ckpt_dir else 0, ckpt_dir=args.ckpt_dir,
        log_every=50, seed=args.seed,
    )
    t0 = time.time()
    model, history = train_dsm(sdes, model, timed_batch_fn, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_starts.append(time.perf_counter())
    wall_min = (time.time() - t0) / 60.0
    walls = np.diff(step_starts)[WARMUP_STEPS:]
    dsm_step_ms = float(np.median(walls) * 1e3) if len(walls) else None

    out = Path(args.ckpt_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "params.npz",
             **{k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()})

    # Post-train check: does the prior sample inside h's dynamic range?
    model.eval()
    sample_h = None
    if args.sample_check:
        single, pair = (torch.from_numpy(np.array(x, np.float32)).to(device) for x in
                        load_embeds(*get_embeds(seqs[0], str(EMBEDS_CACHE), backend="dummy")))
        bundle = Bundle(model=model, sdes=sdes, config={}, device=device,
                        denoiser=partial(denoise.dpm_solver, num_steps=30))
        pos_s, _ = bundle.sampler(args.sample_check, L)(
            torch.Generator(device=device).manual_seed(7), single, pair)
        hs = compute_folded_proportion(pos_s.float(), ref_ca.to(device)).cpu().numpy()
        sample_h = h_summary(hs)
        print(f"sampled h (WT, {args.sample_check} structures): mean={sample_h['mean']:.3f} "
              f"q={sample_h['quantiles']}", file=sys.stderr)

    summary = {
        "loss_first50_mean": float(np.mean(history[:50])),
        "loss_last50_mean": float(np.mean(history[-50:])),
        "steps": args.steps,
        "batch": args.batch,
        "systems": len(seqs),
        "frames_per_system": args.frames,
        "params_M": round(n_params / 1e6, 2),
        "device": device_name(device),
        "wall_minutes": wall_min,
        "dsm_step_ms": dsm_step_ms,
        "ensemble_h": data_h,
        "sampled_h": sample_h,
        "params_npz": str(out / "params.npz"),
    }
    print(json.dumps(summary, indent=2))
    if args.output:
        shown = {k: (str(Path(v).relative_to(REPO)) if k == "csv" and Path(v).is_relative_to(REPO)
                     else v) for k, v in vars(args).items()}
        artifact = {"summary": summary, "loss_history": [round(float(x), 5) for x in history],
                    "args": shown}
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(artifact, indent=1))
        print(f"wrote {args.output}", file=sys.stderr)
    return model, summary


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    main()
