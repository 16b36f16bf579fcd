"""Prepare MEGAScale finetuning CSVs with the PyTorch port (counterpart of
``examples/prepare_megascale.py`` and of the reference repo's `bioemu.ipynb`).

Pipeline (bioemu.ipynb cells 1-5), on a local CSV dump of the MEGAScale
stability dataset (``--input_csv``; fetching it from the HuggingFace hub is
not offered here):
  1. split 80% train / 10% val / 10% test with a fixed seed, in the order
     the JAX example's pandas ``sample(frac=1, random_state=seed)`` gives;
  2. coerce ``dG_ML`` to numeric, drop non-numeric rows;
  3. add ``p_folded = sigmoid(-(-dG_ML) / kT)`` targets via
     :func:`se3diff_torch.ppft.h_functions.compute_folded_proportion_from_dg`;
  4. write ``train.csv / val.csv / test.csv`` plus one short-sequence
     low-dG sample row per split for smoke tests.

No pandas: the CSVs are read and written with :mod:`csv`. Columns other
than ``dG_ML`` keep the text they were read with.

Usage:
    python examples/torch_prepare_megascale.py --input_csv megascale_dataset2.csv \\
        --output_dir datasets/megascale

The output CSVs plug straight into ``python -m se3diff_torch.finetune
--sequence_col aa_seq --h_stars_cols p_folded``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 42  # the JAX example's shuffle seed


def read_rows(path: str) -> tuple[list[str], list[dict]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames or []), list(reader)


def write_rows(path: str, columns: list[str], rows: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for r in rows:
            writer.writerow([r[c] for c in columns])


def add_p_folded(rows: list[dict], dg_col: str = "dG_ML") -> list[dict]:
    """Numeric-coerce the dG column, drop rows without a number, add the
    p_folded target."""
    import torch

    from se3diff_torch.ppft.h_functions import compute_folded_proportion_from_dg

    out = []
    for r in rows:
        try:
            dg = float(r[dg_col])
        except ValueError:
            continue
        if np.isnan(dg):
            continue
        out.append({**r, dg_col: dg})
    dg = torch.as_tensor(-np.asarray([r[dg_col] for r in out], np.float64), dtype=torch.float32)
    p = compute_folded_proportion_from_dg(dg).numpy()
    for r, v in zip(out, p):
        r["p_folded"] = v
    return out


def split_80_10_10(rows: list[dict], seed: int = SEED):
    """80/10/10 shuffled split (bioemu.ipynb cells 1-2's two-stage split),
    shuffled by ``RandomState(seed)``'s permutation, as pandas' ``sample``."""
    order = np.random.RandomState(seed).permutation(len(rows))
    shuffled = [rows[i] for i in order]
    n = len(shuffled)
    n_train = int(round(n * 0.8))
    n_val = int(round(n * 0.1))
    return shuffled[:n_train], shuffled[n_train:n_train + n_val], shuffled[n_train + n_val:]


def pick_smoke_sample(rows: list[dict], seq_col: str, dg_col: str, seed: int = SEED) -> list[dict]:
    """One short (<50 aa), marginally-stable (dG<1) row for smoke tests."""
    eligible = [r for r in rows if len(r[seq_col]) < 50 and r[dg_col] < 1]
    if not eligible:
        return rows[:1]
    return [eligible[np.random.RandomState(seed).permutation(len(eligible))[0]]]


def _text(v) -> str:
    """A cell as pandas writes it: floats in their shortest round-trip form
    (of float32 for the f32 p_folded)."""
    if isinstance(v, np.floating):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    return v


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_csv", required=True, help="local MEGAScale CSV dump")
    p.add_argument("--output_dir", default="datasets/megascale")
    p.add_argument("--sequence_col", default="aa_seq")
    p.add_argument("--dg_col", default="dG_ML")
    p.add_argument("--seed", type=int, default=SEED)
    args = p.parse_args(argv)

    columns, rows = read_rows(args.input_csv)
    columns = columns + ["p_folded"]
    train, val, test = split_80_10_10(rows, seed=args.seed)
    out = args.output_dir
    os.makedirs(out, exist_ok=True)
    for name, part in [("train", train), ("val", val), ("test", test)]:
        part = add_p_folded(part, dg_col=args.dg_col)
        sample = pick_smoke_sample(part, args.sequence_col, args.dg_col, args.seed)
        for path, rs in ((f"{name}.csv", part), (f"{name}_sample.csv", sample)):
            write_rows(os.path.join(out, path), columns,
                       [{k: _text(v) for k, v in r.items()} for r in rs])
        print(f"{name}: {len(part)} rows -> {out}/{name}.csv")


if __name__ == "__main__":
    main()
