"""PPFT learning run on GRB2-SH3 through the port's trainer.

The port's counterpart of ``scripts/ppft_trainer_run_r5.py``, with its flags
and defaults (``--device`` in place of ``--platform``). It fine-tunes a
near-zero control net (2 layers, d64, 4 heads, f32) on a frozen SH3 prior
(``scripts/torch_pretrain_sh3_prior.py``'s ``params.npz``, bioemu-v1.0
widths, bf16) with ``se3diff_torch.ppft.trainer.finetune``: epoch-0
validation, per-epoch validation with best-validation tracking, per-epoch
checkpoints ``finetune_model_{epoch}.npz``, the best as
``finetune_model.npz`` and ``history.json``.

The split is the JAX run's: the seed-0 permutation of the GRB2-SH3 CSV, its
first ``--val_size`` mutants held out for validation, the next
``--train_mutants`` for training (one epoch = that many updates at
``data_batch_size=1``), h* = 1 / (1 + exp(f_dg_pred)). The paths are
recorded with ``euler_maruyama_finetune`` at ``--num_steps`` and path batch
``--batch``; the learning rate is flat (``eta_min == lr``).

    python scripts/torch_ppft_trainer_run.py --prior_params /tmp/sh3_prior/params.npz \\
        --output_dir /tmp/ppft_trainer_run [--kl_guard 80]     # on the card
    python scripts/torch_ppft_trainer_run.py --tiny --device cpu   # smoke

``--init_control`` continues from one of this script's checkpoints
(``finetune_model_{epoch}.npz``); the continued run starts a fresh AdamW
and validates its start again as epoch 0.
"""

from __future__ import annotations

import argparse
import csv
import logging
import sys
from functools import partial
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

GRB2_CSV = REPO / "assets" / "reference_h" / "GRB2_SH3_high_confidence.csv"
EMBEDS_CACHE = REPO / ".embeds_cache_ppft"
# The JAX scripts' tiny score net (a CPU smoke) and the control net
# (bioemu-v1.0's finetune_model block).
TINY_SCORE = dict(num_layers=1, dim_model=16, dim_pair=8, num_heads=2, dim_hidden=16, dropout=0.0)
CONTROL = dict(dim_model=64, dim_pair=32, num_layers=2, num_heads=4, dim_hidden=128, dropout=0.1)
SPLIT_COLUMNS = ("id", "seq", "h_star")


def split_rows(csv_path, seed: int, val_size: int, train_mutants: int):
    """``(train, val)`` rows ``{"id", "seq", "h_star"}``: the seed's
    permutation, its first ``val_size`` rows held out, the next
    ``train_mutants`` for training; h* = sigmoid(-f_dg_pred) in float64."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    h_star = 1.0 / (1.0 + np.exp(np.array([float(r["f_dg_pred"]) for r in rows], np.float64)))
    order = np.random.default_rng(seed).permutation(len(rows))

    def pick(idx):
        return [{"id": rows[i]["id"], "seq": rows[i]["seq"], "h_star": float(h_star[i])} for i in idx]

    return pick(order[val_size:val_size + train_mutants]), pick(order[:val_size])


def write_rows(path: Path, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=SPLIT_COLUMNS)
        w.writeheader()
        w.writerows(rows)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train_mutants", type=int, default=25,
                   help="train-subset size; 1 epoch = this many updates")
    p.add_argument("--val_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--batch", type=int, default=256, help="path batch size")
    p.add_argument("--num_steps", type=int, default=200, help="EM recorder diffusion steps")
    p.add_argument("--lr", type=float, default=2e-3, help="flat (eta_min == lr)")
    p.add_argument("--lambda_", type=float, default=2e-5)
    p.add_argument("--kl_guard", type=float, default=None,
                   help="trust-region threshold in nats (None = reference behavior)")
    p.add_argument("--seed", type=int, default=0,
                   help="split seed; the trainer's generators are seeded by --trainer_seed")
    p.add_argument("--trainer_seed", type=int, default=1)
    p.add_argument("--csv", default=str(GRB2_CSV))
    p.add_argument("--prior_params", default="/tmp/sh3_prior/params.npz",
                   help="frozen prior (scripts/torch_pretrain_sh3_prior.py export)")
    p.add_argument("--init_control", default=None,
                   help="a finetune_model_{epoch}.npz of this script to continue the control from")
    p.add_argument("--output_dir", default="/tmp/ppft_trainer_run")
    p.add_argument("--tiny", action="store_true",
                   help="tiny score net + small batch/steps (CPU smoke)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.tiny:
        args.batch = min(args.batch, 16)
        args.num_steps = min(args.num_steps, 8)
        args.num_epochs = min(args.num_epochs, 2)
        args.train_mutants = min(args.train_mutants, 3)
        args.val_size = min(args.val_size, 2)
    return args


def main(argv=None) -> dict:
    """Run the fine-tuning; returns the best control-net state dict."""
    args = parse_args(argv)

    import torch

    from se3diff_torch.diffusion import denoise
    from se3diff_torch.models.convert import load_checkpoint
    from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights
    from se3diff_torch.ops.ipa_attention import check_card_widths
    from se3diff_torch.ppft.h_functions import FoldingStability
    from se3diff_torch.ppft.trainer import (
        FinetuneBundle, FinetuneConfig, finetune, load_finetune_params,
    )
    from se3diff_torch.sampling.bundle import Bundle, initialize_weights_to_near_zero, resolve_device
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE

    score_kw = TINY_SCORE if args.tiny else {}
    check_card_widths(score_kw, args.device, torch.float32 if args.tiny else torch.bfloat16)
    check_card_widths(CONTROL, args.device, torch.float32, with_pa=False)
    device = resolve_device(args.device)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    train_rows, val_rows = split_rows(args.csv, args.seed, args.val_size, args.train_mutants)
    csv_train, csv_val = out / "train.csv", out / "val.csv"
    write_rows(csv_train, train_rows)
    write_rows(csv_val, val_rows)

    score_model = DiGConditionalScoreModel(
        **score_kw, dtype=torch.float32 if args.tiny else torch.bfloat16)
    if args.prior_params and not args.tiny and Path(args.prior_params).exists():
        score_model.load_state_dict(load_checkpoint(args.prior_params), strict=True)
        print(f"prior loaded from {args.prior_params}", file=sys.stderr)
    elif not args.tiny:
        raise SystemExit(
            f"prior {args.prior_params} missing: run scripts/torch_pretrain_sh3_prior.py first "
            "(a random-init prior saturates h at its clamp; no learning evidence)"
        )
    else:
        init_weights(score_model, torch.Generator().manual_seed(1))
    score_model.requires_grad_(False)

    ft_model = init_weights(DiGConditionalScoreModel(**CONTROL), torch.Generator().manual_seed(2))
    initialize_weights_to_near_zero(ft_model)
    if args.init_control:
        ft_model.load_state_dict(load_finetune_params(args.init_control), strict=True)
        print(f"control continued from {args.init_control}", file=sys.stderr)

    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(sigma_max=2.33, device=device))
    bundle = FinetuneBundle(
        base=Bundle(model=score_model.to(device).eval(), sdes=sdes, denoiser=None, config={},
                    device=device),
        # Dropout stays off, as in the JAX package's deterministic apply.
        finetune_model=ft_model.to(device).eval(),
        denoiser=partial(denoise.euler_maruyama_finetune, num_steps=args.num_steps),
        h_func=FoldingStability(),
    )
    config = FinetuneConfig(
        data_batch_size=1,
        lambda_=args.lambda_,
        batch_size=args.batch,
        num_epochs=args.num_epochs,
        save_every_n_epochs=1,
        val_every_n_epochs=1,
        lr=args.lr,
        eta_min=args.lr,  # flat schedule
        kl_guard=args.kl_guard,
    )
    best = finetune(
        csv_train, csv_val, "seq", ["h_star"], bundle,
        config=config, output_dir=out, cache_embeds_dir=str(EMBEDS_CACHE),
        embeds_backend="dummy", seed=args.trainer_seed,
    )
    print(f"done; history at {out / 'history.json'}", file=sys.stderr)
    return best


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    main()
