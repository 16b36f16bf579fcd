"""Worked example: PPFT observable analysis on the PyTorch port (counterpart
of ``examples/analyze_observables.py``; reference observations.ipynb).

Loads a directory of sampled ``batch_*.npz`` files (as written by
``python -m se3diff_torch.sample`` / ``finetune``), computes the GRB2-SH3
folding + binding observables for every sample — both the hard (0/1)
classification used as the PPFT target and the raw continuous values — and
compares the sampled means against the experimental target h* from the
mutant-scan CSV.

Run on real samples:   python examples/torch_analyze_observables.py SAMPLE_DIR
Run a self-contained demo (no checkpoint needed):
                       python examples/torch_analyze_observables.py --demo

The observables run on ``--device`` (default ``cuda``). Writes
``observables_hist.png`` with FNC and interface-RMSD histograms and the h
thresholds marked (observations.ipynb cells 6-20); ``--no_plot`` skips it.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

_STRUCTURES = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", "structures"))
DEFAULT_PDZ3_REF = os.path.join(_STRUCTURES, "1be9_trimmed.pdb")


def read_dir(output_dir: str) -> tuple[list[str], np.ndarray, np.ndarray]:
    """Stack all batch npz files (observations.ipynb read_dir cell):
    returns (sequences, pos [N, L, 3] nm, node_orientations [N, L, 3, 3])."""
    files = sorted(glob.glob(os.path.join(output_dir, "batch_*.npz")))
    if not files:
        raise SystemExit(f"no batch_*.npz under {output_dir}")
    data = [np.load(f) for f in files]
    seqs = [str(d["sequence"]) for d in data]
    pos = np.concatenate([d["pos"] for d in data], axis=0)
    rot = np.concatenate([d["node_orientations"] for d in data], axis=0)
    return seqs, pos, rot


def demo_samples(ref_nm: np.ndarray, n: int = 256, seed: int = 0) -> np.ndarray:
    """Synthetic 'samples': the reference structure under increasing thermal
    jitter, so the folded fraction sweeps from ~1 to ~0."""
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.005, 0.3, n)[:, None, None]
    return ref_nm[None] + scale * rng.standard_normal((n, *ref_nm.shape))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("sample_dir", nargs="?", default=None)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--system", default="sh3", choices=["sh3", "pdz3"],
                   help="sh3 = GRB2-SH3 (observations.ipynb); "
                        "pdz3 = PSD95-PDZ3 (observations_pdz3.ipynb)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default="observables_hist.png")
    p.add_argument("--no_plot", action="store_true")
    p.add_argument("--hstar_csv", default=None,
                   help="mutant-scan CSV with f_dg_pred/b_dg_pred columns")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but CUDA is not available (use --device cpu)")

    from se3diff_torch.ppft import observables as obs
    from se3diff_torch.ppft.h_functions import DEFAULT_SH3_REF, K_BOLTZMANN
    from se3diff_torch.ppft.observables import (
        LOOP_FOLDED_RMSD_NM,
        PROTEIN_FOLDED_Q_THRESHOLD,
        compute_h_for_grb2_sh3,
        compute_h_for_grb2_sh3_raw,
        compute_h_for_psd95_pdz3,
        compute_h_raw,
        h_star_from_csv,
    )

    if args.system == "sh3":
        ref_path, sysname = DEFAULT_SH3_REF, "GRB2-SH3"
        h_binary_fn, h_raw_fn = compute_h_for_grb2_sh3, compute_h_for_grb2_sh3_raw
        raw1_label = "binding-interface RMSD (nm)"
    else:
        ref_path, sysname = DEFAULT_PDZ3_REF, "PSD95-PDZ3"
        h_binary_fn = compute_h_for_psd95_pdz3
        h_raw_fn = lambda pos, rot, ref: compute_h_raw(pos, ref)  # noqa: E731
        raw1_label = "ligand-loop RMSD (nm)"

    ref_nm = obs.load_ref(ref_path)
    if args.demo or args.sample_dir is None:
        print("demo mode: jittered reference conformations stand in for samples")
        pos = demo_samples(ref_nm)
        seqs = ["(demo)"]
    else:
        seqs, pos, _ = read_dir(args.sample_dir)

    if pos.shape[1] != ref_nm.shape[0]:
        raise SystemExit(
            f"samples have {pos.shape[1]} residues but the {sysname} reference "
            f"has {ref_nm.shape[0]}; these observables are defined for "
            f"{sysname}-length samples"
        )
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=args.device)
    h_bin = h_binary_fn(pos_t, None, ref_path).cpu().numpy()
    h_raw = h_raw_fn(pos_t, None, ref_path).cpu().numpy()

    print(f"samples: {pos.shape[0]}  sequence: {seqs[0][:40]}")
    print(f"mean h (folded, bound)      : {h_bin.mean(0).round(4).tolist()}")
    print(f"mean raw (FNC, RMSD nm)     : {h_raw.mean(0).round(4).tolist()}")
    # dG estimates from the ensemble fold/bind proportions, the quantity the
    # PDZ3 notebook records per mutant (observations_pdz3.ipynb cell 9).
    p_mean = np.clip(h_bin.mean(0), 1e-7, 1 - 1e-7)
    dg = -K_BOLTZMANN * 295.0 * np.log(p_mean / (1.0 - p_mean))
    print(f"dG estimates (fold, bind)    : {dg.round(4).tolist()} kcal/mol")

    if args.hstar_csv:
        star_seqs, h_star = h_star_from_csv(args.hstar_csv)
        match = [i for i, s in enumerate(star_seqs) if s == seqs[0]]
        if match:
            print(f"target h* for this sequence  : {h_star[match[0]].round(4).tolist()}")
        else:
            print(f"sequence not in {args.hstar_csv}; first h* rows:\n{h_star[:3]}")

    if not args.no_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(9, 3.4))
        axes[0].hist(h_raw[:, 0], bins=40, color="steelblue")
        axes[0].axvline(PROTEIN_FOLDED_Q_THRESHOLD, ls="--", c="red",
                        label=f"folded if FNC > {PROTEIN_FOLDED_Q_THRESHOLD}")
        axes[0].set_xlabel("fraction of native contacts")
        axes[0].legend(fontsize=8)
        axes[1].hist(h_raw[:, 1], bins=40, color="darkorange")
        axes[1].axvline(LOOP_FOLDED_RMSD_NM, ls="--", c="red",
                        label=f"bound if RMSD < {LOOP_FOLDED_RMSD_NM} nm")
        axes[1].set_xlabel(raw1_label)
        axes[1].legend(fontsize=8)
        fig.suptitle(f"{sysname} observables, {pos.shape[0]} samples "
                     f"(folded {h_bin[:, 0].mean():.0%}, bound {h_bin[:, 1].mean():.0%})")
        fig.tight_layout()
        fig.savefig(args.out, dpi=130)
        print(f"wrote {args.out}")
    return dict(h_binary=h_bin, h_raw=h_raw, dg=dg)


if __name__ == "__main__":
    main()
