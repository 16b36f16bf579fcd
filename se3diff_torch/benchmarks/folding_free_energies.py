"""Folding free-energy benchmark: FNC -> dG/ddG + error analysis.

Counterpart of `bioemu-benchmarks/bioemu_benchmarks/eval/
folding_free_energies/{fraction_native_contacts,free_energies,analysis,
evaluate}.py`. CA-contact FNC scores per system give fold/unfold counts at an
adaptive KDE threshold, Boltzmann-inverted into dG (ddG vs wildtype), with
Clopper-Pearson confidence intervals and MAE/Pearson/Spearman against
experiment.

Counterpart of ``se3diff_tpu/benchmarks/folding_free_energies.py``. Its
DataFrames are lists of row dicts here (a missing cell is NaN), and the
results CSVs are written by :func:`~se3diff_torch.benchmarks.core.write_csv`
with pandas' columns, rows and number format.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from itertools import combinations
from pathlib import Path

import numpy as np

from se3diff_torch.benchmarks.align import matching_positions
from se3diff_torch.benchmarks.core import (
    Benchmark,
    BenchmarkResults,
    read_csv,
    rows_where,
    table_columns,
    write_csv,
)
from se3diff_torch.benchmarks.samples import IndexedSamples
from se3diff_torch.benchmarks.trajectory import BackboneTraj, load_reference_pdb

logger = logging.getLogger(__name__)

K_BOLTZMANN = 0.001987203599772605  # kcal / mol / K (free_energies.py:11)


@dataclass(frozen=True)
class FNCSettings:
    """(fraction_native_contacts.py:14-32)"""

    sequence_separation: int = 3
    contact_cutoff: float = 10.0
    contact_beta: float = 5.0
    contact_delta: float = 0.0
    contact_lambda: float = 1.2


def get_fnc_from_samples_trajectory(
    samples: BackboneTraj,
    reference: BackboneTraj,
    settings: FNCSettings = FNCSettings(),
) -> np.ndarray:
    """Soft FNC per frame over CA contacts (fraction_native_contacts.py:
    172-237; the reference slices to CA before contact computation)."""
    ref_ca = reference.ca()[0]  # [R, 3] Angstrom
    L = ref_ca.shape[0]

    # Symmetric contact list with sequence separation + cutoff
    # (fraction_native_contacts.py:35-81).
    dist = np.linalg.norm(ref_ca[:, None] - ref_ca[None, :], axis=-1)
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    mask = (sep > settings.sequence_separation) & (dist <= settings.contact_cutoff)
    ii, jj = np.where(mask)  # symmetric: both (i,j) and (j,i) present
    d_ref = dist[ii, jj]

    # Map reference residue indices to sample indices via alignment.
    pairs = matching_positions(samples.sequence, reference.sequence)
    ref_to_sample = np.full(L, -1, np.int64)
    for s, r in pairs:
        ref_to_sample[r] = s
    valid = (ref_to_sample[ii] >= 0) & (ref_to_sample[jj] >= 0)
    si, sj, d_ref = ref_to_sample[ii[valid]], ref_to_sample[jj[valid]], d_ref[valid]

    sam_ca = samples.ca()  # [F, Rs, 3]
    d_sam = np.linalg.norm(sam_ca[:, si] - sam_ca[:, sj], axis=-1)
    # Overflow-safe logistic (reference uses scipy expit semantics,
    # fraction_native_contacts.py:35-237): split on sign so exp only ever
    # sees non-positive arguments.
    x = -settings.contact_beta * (
        d_sam - settings.contact_lambda * (d_ref[None] + settings.contact_delta)
    )
    q = np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.abs(x))), np.exp(-np.abs(x)) / (1.0 + np.exp(-np.abs(x))))
    return q.mean(axis=-1)


def _compute_dg(sampled_fnc: np.ndarray, threshold: float, temperature: float) -> float:
    """(free_energies.py:14-38)"""
    n_fold = int(np.sum(sampled_fnc >= threshold))
    n_unfold = int(np.sum(sampled_fnc < threshold))
    if n_fold == 0:
        ratio = 1e-10
    elif n_unfold == 0:
        ratio = 1e10
    else:
        ratio = n_fold / n_unfold
    return float(-np.log(ratio) * K_BOLTZMANN * temperature)


def _compute_threshold(
    fnc: np.ndarray,
    min_abs_thr: int = 45,
    max_abs_thr: int = 90,
    margin_ratio_low: float = 0.2,
    margin_ratio_high: float = 0.3,
    bandwidth: float = 0.03,
) -> float:
    """Adaptive KDE threshold between folded/unfolded modes
    (free_energies.py:41-93)."""
    hist_edges = np.histogram(fnc, bins=100, density=True, range=(0, 1))[1]
    min_data, max_data = float(fnc.min()), float(fnc.max())
    rng = max_data - min_data

    # Gaussian-KDE log density at the 101 bin edges.
    bw = max(bandwidth * rng, 1e-12)
    diff = (hist_edges[:, None] - fnc[None, :]) / bw
    log_kernel = -0.5 * diff**2 - 0.5 * np.log(2 * np.pi) - np.log(bw)
    m = log_kernel.max(axis=1, keepdims=True)
    kde_score = (
        m[:, 0] + np.log(np.exp(log_kernel - m).sum(axis=1)) - np.log(len(fnc))
    )

    max_thr = int(min(max_data * 100 - margin_ratio_high * rng * 100, max_abs_thr))
    min_thr = int(max(min_data * 100 + margin_ratio_low * rng * 100, min_abs_thr))

    if min_thr >= max_thr:
        logger.info("min_thr >= max_thr (%d >= %d)", min_thr, max_thr)
        if min_thr == min_abs_thr:
            return 1.0
        if max_thr == max_abs_thr:
            return 0.0
        raise ValueError(f"min_thr ({min_thr}) >= max_thr ({max_thr})")

    relative_index = int(np.argmin(kde_score[min_thr:max_thr]))
    return (float(min_thr) + relative_index) / len(kde_score)


def compute_dg_ddg_from_fnc(
    *,
    dict_fnc: dict[str, np.ndarray],
    system_info: list[dict],
    fixed_threshold: float | None = None,
    temperature: float = 295.0,
) -> list[dict]:
    """(free_energies.py:96-176) One row a test case: its ``system_info``
    row with the threshold, temperature, sample count, ``dg_pred`` and, for
    a mutant whose wild type was sampled, ``ddg_pred``."""
    results: dict[str, dict] = {}
    for test_case, fnc in dict_fnc.items():
        threshold = (
            _compute_threshold(fnc) if fixed_threshold is None else fixed_threshold
        )
        row = dict(rows_where(system_info, "name", test_case)[0])
        results[test_case] = row
        row["threshold"] = threshold
        row["temperature"] = temperature
        target = row["num_samples"]
        if len(fnc) < 0.7 * target:
            logger.warning(
                "Samples for %s below recommendation (%d/%d).",
                test_case, len(fnc), target,
            )
        row["num_samples"] = len(fnc)
        row["dg_pred"] = _compute_dg(fnc, threshold, temperature)

    for test_case, row in results.items():
        wt = row["name_wt"]
        if test_case == wt:
            continue
        if wt not in results:
            logger.warning("No wild type results for %s (ddG)", wt)
            continue
        row["ddg_pred"] = row["dg_pred"] - results[wt]["dg_pred"]

    return list(results.values())


def _col(rows: list[dict], name: str, dtype=float) -> np.ndarray:
    """Column ``name`` as an array, NaN where a row lacks it."""
    return np.asarray([r.get(name, np.nan) for r in rows], dtype)


def _clopper_pearson_confidence_interval(
    predicted_dG, num_samples, temperature, confidence: float = 0.95, epsilon=1e-10
):
    """(analysis.py:14-56)"""
    from scipy.stats import beta

    predicted_dG = np.asarray(predicted_dG, float)
    num_samples = np.asarray(num_samples, int)
    temperature = np.asarray(temperature, float)
    ratio = np.exp(-predicted_dG / (K_BOLTZMANN * temperature))
    p_folded = ratio / (1 + ratio)
    k = np.round(p_folded * num_samples).astype(int)
    alpha = 1 - confidence
    lower = np.zeros(len(k)) + epsilon
    lower[k > 0] = beta.ppf(alpha / 2, k, num_samples - k + 1)[k > 0]
    upper = np.ones(len(k)) - epsilon
    upper[k < num_samples] = beta.ppf(1 - alpha / 2, k + 1, num_samples - k)[
        k < num_samples
    ]
    dG_upper = -K_BOLTZMANN * temperature * np.log(lower / (1 - lower))
    dG_lower = -K_BOLTZMANN * temperature * np.log(upper / (1 - upper))
    return dG_upper, dG_lower


def _set_col(rows: list[dict], name: str, values) -> None:
    for r, v in zip(rows, values):
        r[name] = float(v)


def compute_confidence_intervals_dg(rows: list[dict], confidence: float = 0.95) -> list[dict]:
    """(analysis.py:59-97)"""
    p = _col(rows, "dg_pred")
    t = _col(rows, "dg_exp")
    _set_col(rows, "exp_errors_dg_lower", t - _col(rows, "dg_ci95_high"))
    _set_col(rows, "exp_errors_dg_upper", _col(rows, "dg_ci95_low") - t)
    upper, lower = _clopper_pearson_confidence_interval(
        p, _col(rows, "num_samples", int), _col(rows, "temperature"),
        confidence=confidence,
    )
    err_lower, err_upper = p - lower, upper - p
    _set_col(rows, "model_errors_dg_lower", err_lower * (err_lower > 0))
    _set_col(rows, "model_errors_dg_upper", err_upper * (err_upper > 0))
    return rows


def compute_confidence_intervals_ddg(rows: list[dict], confidence: float = 0.975) -> list[dict]:
    """(analysis.py:100-155)"""
    missing = np.isnan(_col(rows, "ddg_pred"))
    if missing.all():
        _set_col(rows, "model_errors_ddg_lower", [np.nan] * len(rows))
        _set_col(rows, "model_errors_ddg_upper", [np.nan] * len(rows))
        return rows
    sub = [r for r, m in zip(rows, missing) if not m]
    p_ddg = _col(sub, "ddg_pred")
    p_dg_mut = _col(sub, "dg_pred")
    temperature = _col(sub, "temperature")
    n = _col(sub, "num_samples", int)
    dg_by_name = {}
    for r in rows:
        dg_by_name.setdefault(r["name"], r["dg_pred"])
    p_dg_wt = np.asarray([dg_by_name.get(r["name_wt"], np.nan) for r in sub], float)
    wt_up, wt_lo = _clopper_pearson_confidence_interval(p_dg_wt, n, temperature, confidence)
    mu_up, mu_lo = _clopper_pearson_confidence_interval(p_dg_mut, n, temperature, confidence)
    lo = mu_lo - wt_up
    up = mu_up - wt_lo
    err_lower = p_ddg - lo
    err_upper = up - p_ddg
    unl = np.full(len(rows), np.nan)
    unu = np.full(len(rows), np.nan)
    unl[~missing] = err_lower * (err_lower > 0)
    unu[~missing] = err_upper * (err_upper > 0)
    _set_col(rows, "model_errors_ddg_lower", unl)
    _set_col(rows, "model_errors_ddg_upper", unu)
    return rows


def compute_error_metrics(model_pred: np.ndarray, exp_targets: np.ndarray) -> dict:
    """MAE + Pearson + Spearman (analysis.py:234-247)."""
    from scipy.stats import spearmanr

    return {
        "mae": float(np.mean(np.abs(model_pred - exp_targets))),
        "pearson_corrcoef": float(np.corrcoef(model_pred, exp_targets)[0, 1]),
        "spearman_corrcoef": float(spearmanr(model_pred, exp_targets)[0]),
    }


def analyze_dg(rows: list[dict]) -> dict:
    """(analysis.py:249-301, metrics only; plotting in results.plot)"""
    sub = [r for r in rows if not bool(r["wt_only_reference"])]
    assert len(sub) > 0, "No data found for delta G benchmark."
    return compute_error_metrics(_col(sub, "dg_pred"), _col(sub, "dg_exp"))


def analyze_ddg(rows: list[dict]) -> dict:
    """(analysis.py:303-336)"""
    sub = [r for r in rows if not np.isnan(r.get("ddg_pred", np.nan))]
    assert len(sub) > 0, "No data found for delta delta G benchmark."
    return compute_error_metrics(_col(sub, "ddg_pred"), _col(sub, "ddg_exp"))


def load_reference(test_case: str) -> BackboneTraj:
    """(eval/folding_free_energies/utils.py:8-21)"""
    paths = list(
        Path(Benchmark.FOLDING_FREE_ENERGIES.asset_dir).glob(f"**/{test_case}.pdb")
    )
    assert len(paths) == 1, f"Expected 1 reference for {test_case}, found {len(paths)}"
    return load_reference_pdb(paths[0])


@dataclass
class FoldingFreeEnergiesResults(BenchmarkResults):
    """(evaluate.py:29-90) ``free_energies_per_system``: one row a test
    case; ``metrics``: ``{"dG" | "ddG": {metric: value}}``."""

    benchmark: Benchmark
    temperature_K: float
    fnc_per_system: dict[str, np.ndarray]
    free_energies_per_system: list[dict]
    metrics: dict[str, dict[str, float]]

    def save_results(self, output_dir) -> None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        rows = self.free_energies_per_system
        write_csv(out / "results_systems.csv", rows, table_columns(rows))
        metric_rows = [{"benchmark": k, **v} for k, v in self.metrics.items()]
        write_csv(out / "results_metrics.csv", metric_rows,
                  table_columns(list(self.metrics.values())), index="benchmark")
        np.savez(out / "contact_scores.npz", **self.fnc_per_system)

    def get_aggregate_metrics(self) -> dict[str, float]:
        agg = {}
        for idx, row in self.metrics.items():
            agg.update({f"{idx}_{k}": v for k, v in row.items()})
        return agg

    def plot(self, output_dir) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        rows = self.free_energies_per_system
        for quantity, pred_col, exp_col, rng in (
            ("dG", "dg_pred", "dg_exp", (-5.5, 2)),
            ("ddG", "ddg_pred", "ddg_exp", (-2, 5)),
        ):
            if pred_col not in table_columns(rows):
                continue
            pred = _col(rows, pred_col)
            keep = ~np.isnan(pred)
            fig, ax = plt.subplots(figsize=(4, 4))
            ax.plot(rng, rng, c="grey", lw=0.8)
            ax.scatter(_col(rows, exp_col)[keep], pred[keep], s=9)
            ax.set_xlabel(f"experimental {quantity} (kcal/mol)")
            ax.set_ylabel(f"predicted {quantity} (kcal/mol)")
            fig.tight_layout()
            fig.savefig(out / f"scatter_{quantity}.png", dpi=120)
            plt.close(fig)


def evaluate_folding_free_energies(
    indexed_samples: IndexedSamples,
    temperature_K: float = 295,
) -> FoldingFreeEnergiesResults:
    """(evaluate.py:93-158)"""
    benchmark = Benchmark.FOLDING_FREE_ENERGIES
    dict_fnc: dict[str, np.ndarray] = {}
    for test_case, sss in indexed_samples.test_case_to_sequencesamples.items():
        reference = load_reference(test_case)
        scores = [
            get_fnc_from_samples_trajectory(ss.get_traj(), reference) for ss in sss
        ]
        dict_fnc[test_case] = np.concatenate(scores)

    system_info = read_csv(Path(benchmark.asset_dir) / "system_info.csv")
    rows = compute_dg_ddg_from_fnc(
        dict_fnc=dict_fnc, system_info=system_info, temperature=temperature_K
    )
    rows = compute_confidence_intervals_dg(rows)
    rows = compute_confidence_intervals_ddg(rows)

    metrics: dict[str, dict[str, float]] = {}
    for name, analyze in (("dG", analyze_dg), ("ddG", analyze_ddg)):
        try:
            metrics[name] = analyze(rows)
        except AssertionError as e:
            logger.warning("%s analysis skipped: %s", name, e)

    return FoldingFreeEnergiesResults(
        benchmark=benchmark,
        temperature_K=temperature_K,
        fnc_per_system=dict_fnc,
        free_energies_per_system=rows,
        metrics=metrics,
    )
