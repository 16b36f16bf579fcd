"""Benchmark CLI: ``python -m se3diff_torch.benchmarks {specs,eval}``.

Counterpart of ``se3diff_tpu/benchmarks/cli.py``, with the same flags and
outputs; the specs table is written with :mod:`csv`.

Counterpart of `bioemu-benchmarks/bioemu_benchmarks/scripts/bioemu_bench.py`:
``specs`` prints the test-case table; ``eval`` runs one or more benchmarks on
a sample directory, writing per-benchmark results, ``filter_statistics.json``
and an aggregate ``benchmark_metrics.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np

from se3diff_torch.benchmarks.core import (
    ALL_BENCHMARKS,
    SPECS_COLUMNS,
    Benchmark,
    benchmark_specs_frame,
    write_csv,
)
from se3diff_torch.benchmarks.samples import (
    IndexedSamples,
    filter_unphysical_samples,
    find_samples_in_dir,
)

logger = logging.getLogger(__name__)


def run_benchmark(
    benchmark: Benchmark,
    indexed_samples: IndexedSamples,
    output_dir: Path,
    n_jobs: int = 0,
    plot: bool = True,
) -> dict[str, float]:
    """Dispatch one benchmark (evaluator_utils.py:19-47 + bioemu_bench.py:90-159)."""
    from se3diff_torch.benchmarks.core import MULTICONF_BENCHMARKS

    out = output_dir / benchmark.value
    out.mkdir(parents=True, exist_ok=True)

    if benchmark in MULTICONF_BENCHMARKS:
        from se3diff_torch.benchmarks.multiconf import (
            MULTICONF_METRIC_TYPES,
            compute_coverage_and_k_recall,
            evaluate_multiconf,
        )

        # ood60 + crypticpocket align/measure on local residue subsets;
        # oodval + domainmotion are global (evaluator_utils.py:19-47).
        local = benchmark in (
            Benchmark.MULTICONF_OOD60, Benchmark.MULTICONF_CRYPTICPOCKET
        )
        evals = evaluate_multiconf(
            indexed_samples,
            references_dir=os.path.join(benchmark.asset_dir, "reference"),
            metric_types=MULTICONF_METRIC_TYPES,
            references_localresidinfo_dir=(
                os.path.join(benchmark.asset_dir, "local_residinfo") if local else None
            ),
            n_jobs=n_jobs,
        )
        results = compute_coverage_and_k_recall(evals, benchmark)
        results.save_results(out)
        if plot:
            results.plot(out)
        return results.to_metrics_json()

    if benchmark == Benchmark.SINGLECONF_LOCALUNFOLDING:
        from se3diff_torch.benchmarks.multiconf import (
            compute_coverage_and_k_recall,
            evaluate_singleconf_unfolding,
        )

        evals = evaluate_singleconf_unfolding(
            indexed_samples,
            references_dir=os.path.join(benchmark.asset_dir, "reference"),
            references_localresidinfo_dir=os.path.join(
                benchmark.asset_dir, "local_residinfo"
            ),
            n_jobs=n_jobs,
        )
        results = compute_coverage_and_k_recall(evals, benchmark)
        results.save_results(out)
        if plot:
            results.plot(out)
        return results.to_metrics_json()

    if benchmark == Benchmark.FOLDING_FREE_ENERGIES:
        from se3diff_torch.benchmarks.folding_free_energies import (
            evaluate_folding_free_energies,
        )

        results = evaluate_folding_free_energies(indexed_samples)
        results.save_results(out)
        if plot:
            results.plot(out)
        return results.get_aggregate_metrics()

    if benchmark == Benchmark.MD_EMULATION:
        from se3diff_torch.benchmarks.md_emulation import evaluate_md_emulation

        results = evaluate_md_emulation(indexed_samples)
        results.save_results(out)
        if plot:
            results.plot(out)
        return results.get_aggregate_metrics()

    raise ValueError(f"unknown benchmark {benchmark}")


def run_benchmarks(
    benchmarks: list[Benchmark],
    samples_dir: str | list[str],
    output_dir: str,
    skip_filtering: bool = False,
    n_jobs: int = 0,
    plot: bool = True,
) -> dict:
    """(bioemu_bench.py:90-159); like the reference's --sample_dirs, one or
    several sample directories may be given."""
    output = Path(output_dir)
    output.mkdir(parents=True, exist_ok=True)
    dirs = [samples_dir] if isinstance(samples_dir, (str, Path)) else list(samples_dir)
    found = []
    for d in dirs:
        found.extend(find_samples_in_dir(d))
    if not found:
        raise SystemExit(f"No samples found in {dirs}")

    aggregate: dict[str, dict] = {}
    for benchmark in benchmarks:
        logger.info("Running benchmark %s", benchmark.value)
        try:
            indexed = IndexedSamples.from_benchmark(benchmark, found)
        except Exception as exc:
            logger.warning("Skipping %s: %s", benchmark.value, exc)
            continue
        if not skip_filtering:
            indexed, kept = filter_unphysical_samples(indexed)
            stats = {tc: list(map(float, v)) for tc, v in kept.items()}
            bench_out = output / benchmark.value
            bench_out.mkdir(parents=True, exist_ok=True)
            with open(bench_out / "filter_statistics.json", "w") as f:
                json.dump(stats, f, indent=2)
        metrics = run_benchmark(benchmark, indexed, output, n_jobs=n_jobs, plot=plot)
        aggregate[benchmark.value] = {
            k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
            for k, v in metrics.items()
        }

    with open(output / "benchmark_metrics.json", "w") as f:
        json.dump(aggregate, f, indent=2)
    return aggregate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m se3diff_torch.benchmarks", description=__doc__
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("specs", help="print benchmark test-case table")
    sp.add_argument("--output_csv", default=None)

    ep = sub.add_parser("eval", help="evaluate sample directory")
    ep.add_argument("samples_dir", nargs="+",
                    help="one or more sample directories (*.pdb + *.xtc)")
    ep.add_argument("--benchmarks", nargs="+", default=["all"],
                    help=f"names from {[b.value for b in ALL_BENCHMARKS]} or 'all'")
    ep.add_argument("--output_dir", required=True)
    ep.add_argument("--skip_filtering", action="store_true")
    ep.add_argument("--n_jobs", type=int, default=0)
    ep.add_argument("--no_plots", action="store_true")
    return p


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.command == "specs":
        text = write_csv(args.output_csv, benchmark_specs_frame(), SPECS_COLUMNS)
        if not args.output_csv:
            print(text)
        return

    names = args.benchmarks
    if names == ["all"]:
        benchmarks = ALL_BENCHMARKS
    else:
        benchmarks = [Benchmark(n) for n in names]
    run_benchmarks(
        benchmarks,
        samples_dir=args.samples_dir,
        output_dir=args.output_dir,
        skip_filtering=args.skip_filtering,
        n_jobs=args.n_jobs,
        plot=not args.no_plots,
    )


if __name__ == "__main__":
    main()
