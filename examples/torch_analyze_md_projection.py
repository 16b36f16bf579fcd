"""Worked example: projecting an MD (or sampled) trajectory onto the
MD-emulation free-energy landscape with the PyTorch port (counterpart of
``examples/analyze_md_projection.py``; reference observations_md.ipynb +
bioemu-benchmarks eval/md_emulation).

Two analyses, mirroring the reference notebook:

1. **FES projection** — contact-map features of every frame are projected
   through the benchmark's shipped linear projections
   (assets/benchmarks/md_emulation_*/projection parameters) and scored
   against the reference MD free-energy surface (MAE/RMSE in kcal/mol),
   exactly what ``python -m se3diff_torch.benchmarks eval --benchmarks
   md_emulation`` does per system (host-side numpy).
2. **Observable scatter** — for SH3-length (L=56) trajectories, the raw
   (FNC, interface RMSD) observables per frame on ``--device``, the scatter
   observations_md.ipynb draws for MD frames (cells 9-11).

Run on the vendored fixture (no checkpoint or MD install needed):
    python examples/torch_analyze_md_projection.py
Run on your own pdb+xtc pair (the sample CLI's topology.pdb + samples.xtc):
    python examples/torch_analyze_md_projection.py TOP.pdb TRAJ.xtc
``--no_plot`` skips the figures and the matplotlib import.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

_FIXTURE = os.path.normpath(
    os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "..", "tests", "test_data", "samples_example", "md_emulation",
    )
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("pdb", nargs="?", default=None, help="topology PDB")
    p.add_argument("xtc", nargs="?", default=None, help="trajectory XTC")
    p.add_argument("--out", default="md_projection.png")
    p.add_argument("--no_plot", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the SH3 observables")
    p.add_argument("--n_resample", type=int, default=20000,
                   help="FES resample count (reference default 1e6; the "
                        "fixture-sized demo uses fewer)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but CUDA is not available (use --device cpu)")

    from se3diff_torch.benchmarks.core import Benchmark
    from se3diff_torch.benchmarks.md_emulation import (
        METRIC_COLUMNS,
        DistributionMetricSettings,
        evaluate_md_emulation,
    )
    from se3diff_torch.benchmarks.samples import (
        IndexedSamples,
        SequenceSample,
        find_samples_in_dir,
    )

    if args.pdb is None:
        print(f"using the vendored fixture under {_FIXTURE}")
        found = find_samples_in_dir(_FIXTURE)
    else:
        found = [SequenceSample(topology_file=args.pdb, trajectory_file=args.xtc)]
    # Key each system by its benchmark test case via sequence match.
    indexed = IndexedSamples.from_benchmark(Benchmark.MD_EMULATION, found)

    results = evaluate_md_emulation(
        indexed,
        settings=DistributionMetricSettings(n_resample=args.n_resample),
    )
    print("\nper-system FES metrics (kcal/mol):")
    width = max(len(tc) for tc in results.metrics)
    print(f"{'test_case':<{width}}  " + "  ".join(f"{c:>8}" for c in METRIC_COLUMNS))
    for tc, row in results.metrics.items():
        print(f"{tc:<{width}}  " + "  ".join(f"{row[c]:8.4f}" for c in METRIC_COLUMNS))

    out_dir = os.path.dirname(os.path.abspath(args.out)) or "."
    if not args.no_plot:
        results.plot(out_dir)
        print(f"wrote FES comparison plots under {out_dir}/")

    # observations_md.ipynb-style raw-observable scatter for SH3-length
    # systems: FNC vs binding-interface RMSD per frame.
    from se3diff_torch.ppft.h_functions import DEFAULT_SH3_REF
    from se3diff_torch.ppft.observables import compute_h_for_grb2_sh3_raw

    scatter = {}
    for tc, sss in sorted(indexed.test_case_to_sequencesamples.items()):
        traj = sss[0].get_traj()
        ca = traj.ca() / 10.0  # Angstrom -> nm (model convention)
        if ca.shape[1] != 56:
            continue
        h = compute_h_for_grb2_sh3_raw(
            torch.as_tensor(ca, dtype=torch.float32, device=args.device), None, DEFAULT_SH3_REF
        ).cpu().numpy()
        scatter[tc] = h
        if args.no_plot:
            continue
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(4.5, 3.6))
        ax.scatter(h[:, 0], h[:, 1] * 10.0, s=8, alpha=0.6)
        ax.set_xlabel("fraction of native contacts")
        ax.set_ylabel("interface RMSD (A)")
        ax.set_title(f"{tc}: MD frames in observable space")
        fig.tight_layout()
        fig.savefig(args.out, dpi=130)
        print(f"wrote {args.out} (raw-h scatter for {tc})")
    return dict(metrics=results.metrics, scatter=scatter)


if __name__ == "__main__":
    main()
