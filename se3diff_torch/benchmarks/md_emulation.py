"""MD emulation benchmark: contact-map projections -> 2D free-energy errors.

Counterpart of `bioemu-benchmarks/bioemu_benchmarks/eval/md_emulation/
{projections,state_metric,utils,evaluate}.py`. Samples are featurized as
upper-triangular soft contact maps (exp(-d/0.8), trimmed/neighbor-excluded),
linearly projected with the shipped whitening parameters, and scored against
reference MD projections by free-energy-surface MAE/RMSE/coverage on a noised
2D histogram.

Counterpart of ``se3diff_tpu/benchmarks/md_emulation.py``; the metrics table
is ``{test_case: {"mae", "rmse", "coverage"}}`` with a ``"mean"`` row last,
written as pandas writes JAX's DataFrame.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from se3diff_torch.benchmarks.core import (
    MD_EMULATION_ASSET_DIR,
    Benchmark,
    BenchmarkResults,
    write_csv,
)
from se3diff_torch.benchmarks.samples import IndexedSamples
from se3diff_torch.benchmarks.trajectory import BackboneTraj

logger = logging.getLogger(__name__)

K_BOLTZMANN = 0.001987203599772605  # kcal / mol / K
METRIC_COLUMNS = ["mae", "rmse", "coverage"]


@dataclass
class ProjectionParameters:
    """(projections.py:7-20)"""

    sqrt_inv_cov: np.ndarray
    mean: np.ndarray


@dataclass(frozen=True)
class FeatureSettings:
    """(projections.py:23-36)"""

    n_trim: int = 2
    exclude_neighbors: int = 2
    effective_distance: float = 0.8  # nm


@dataclass(frozen=True)
class DistributionMetricSettings:
    """(state_metric.py:10-29)"""

    n_resample: int = 1_000_000
    sigma_resample: float = 0.25
    num_bins: int = 50
    energy_cutoff: float = 4.0
    padding: float = 0.5


def compute_features(
    traj: BackboneTraj, settings: FeatureSettings = FeatureSettings()
) -> np.ndarray:
    """Upper-triangular soft contact maps per frame (projections.py:82-152).

    Coordinates are converted to nm (the reference's mdtraj xyz are nm).
    """
    n = traj.n_residues
    ca = traj.ca()[:, settings.n_trim : n - settings.n_trim] / 10.0  # nm
    d = np.linalg.norm(ca[:, :, None] - ca[:, None, :], axis=-1)
    idx = np.arange(ca.shape[1])
    neighbor = np.abs(idx[:, None] - idx[None, :]) <= settings.exclude_neighbors
    d[:, neighbor] = 0.0
    feats = np.minimum(np.exp(-d / settings.effective_distance), 1.0)
    iu, ju = np.triu_indices(ca.shape[1])
    return feats[:, iu, ju]


def project_features(features: np.ndarray, params: ProjectionParameters) -> np.ndarray:
    """(projections.py:64-79)"""
    return (features - params.mean) @ params.sqrt_inv_cov


def load_reference_projections() -> dict[str, np.ndarray]:
    """(eval/md_emulation/utils.py:10-25)"""
    path = (
        Path(MD_EMULATION_ASSET_DIR)
        / Benchmark.MD_EMULATION.value.lower()
        / "reference_projections.npz"
    )
    return dict(np.load(path))


def load_projection_parameters() -> dict[str, ProjectionParameters]:
    """(eval/md_emulation/utils.py:28-52)"""
    d = Path(MD_EMULATION_ASSET_DIR) / Benchmark.MD_EMULATION.value.lower()
    sqrt_inv_cov = dict(np.load(d / "projections_sqrt_inv_cov.npz"))
    mean = dict(np.load(d / "projections_mean.npz"))
    assert set(mean) == set(sqrt_inv_cov)
    return {
        tc: ProjectionParameters(sqrt_inv_cov=sqrt_inv_cov[tc], mean=mean[tc])
        for tc in sqrt_inv_cov
    }


# ------------------------------------------------------------------ #
# State metric (state_metric.py)                                      #
# ------------------------------------------------------------------ #


def histogram_bin_edges(x, num_bins: int, padding: float | None = 0.5) -> np.ndarray:
    """(state_metric.py:32-54)"""
    x_min, x_max = float(np.min(x)), float(np.max(x))
    if padding is not None:
        delta = (x_max - x_min) / (num_bins + 1)
        x_min -= padding * delta
        x_max += padding * delta
    return np.linspace(x_min, x_max, num_bins + 1)


def resample_with_noise(x, num_samples, sigma, rng=None) -> np.ndarray:
    """(state_metric.py:73-97)"""
    rng = np.random.default_rng(rng)
    sel = rng.choice(np.arange(x.shape[0]), size=num_samples)
    return x[sel] + sigma * rng.standard_normal((num_samples, x.shape[1]))


def compute_rmse(pred, target, minimize: bool = True) -> float:
    """(state_metric.py:100-125)"""
    shift = float(np.mean(target) - np.mean(pred)) if minimize else 0.0
    return float(np.sqrt(np.mean((pred - target + shift) ** 2)))


def compute_mae(pred, target, minimize: bool = True) -> float:
    """Optimal-shift MAE (state_metric.py:128-157).

    The reference bisects the subgradient for the optimal shift; the exact
    minimizer of ``mean |pred - target + delta|`` is
    ``delta = median(target - pred)``, which is what the bisection converges
    to (and is robust where the reference's bracket can fail).
    """
    shift = float(np.median(target - pred)) if minimize else 0.0
    return float(np.mean(np.abs(pred - target + shift)))


class DistributionMetrics2D:
    """Free-energy-surface comparison on a noised 2D histogram
    (state_metric.py:160-290)."""

    def __init__(
        self,
        reference_projections: np.ndarray,
        n_resample: int = 1_000_000,
        sigma_resample: float = 0.25,
        num_bins: int = 50,
        energy_cutoff: float = 4.0,
        temperature_K: float = 300.0,
        padding: float = 0.5,
        random_seed: int | None = None,
    ):
        self.n_resample = n_resample
        self.sigma_resample = sigma_resample
        self.kBT = temperature_K * K_BOLTZMANN
        self.energy_cutoff = energy_cutoff
        self.random_seed = random_seed

        noised = resample_with_noise(
            reference_projections, n_resample, sigma_resample, rng=random_seed
        )
        self.edges_x = histogram_bin_edges(noised[:, 0], num_bins, padding)
        self.edges_y = histogram_bin_edges(noised[:, 1], num_bins, padding)
        self.density_ref, _, _ = np.histogram2d(
            noised[:, 0], noised[:, 1], bins=(self.edges_x, self.edges_y), density=True
        )
        self.low_energy_mask = self.density_ref > self._density_cutoff(self.density_ref)

    def _density_cutoff(self, density: np.ndarray) -> float:
        energy_min = -self.kBT * np.log(np.max(density))
        return float(np.exp(-(energy_min + self.energy_cutoff) / self.kBT))

    def _sample_density(self, sample_projections: np.ndarray) -> np.ndarray:
        noised = resample_with_noise(
            sample_projections, self.n_resample, self.sigma_resample, rng=self.random_seed
        )
        density, _, _ = np.histogram2d(
            noised[:, 0], noised[:, 1], bins=(self.edges_x, self.edges_y), density=True
        )
        return density

    def score(self, sample_projections: np.ndarray) -> tuple[float, float]:
        """Clamped-density variant (state_metric.py:238-268)."""
        density = self._sample_density(sample_projections)
        padded = np.maximum(density, self._density_cutoff(density))
        e_sam = -self.kBT * np.log(padded[self.low_energy_mask])
        e_ref = -self.kBT * np.log(self.density_ref[self.low_energy_mask])
        return compute_mae(e_sam, e_ref), compute_rmse(e_sam, e_ref)

    def score_nonzero(self, sample_projections: np.ndarray) -> tuple[float, float, float]:
        """Common-support variant + coverage (state_metric.py:270-301)."""
        density = self._sample_density(sample_projections)
        common = np.logical_and(self.low_energy_mask, density > 0)
        e_ref = -self.kBT * np.log(self.density_ref[common])
        e_sam = -self.kBT * np.log(density[common])
        coverage = float(
            np.count_nonzero(common) / np.count_nonzero(self.low_energy_mask)
        )
        return compute_mae(e_sam, e_ref), compute_rmse(e_sam, e_ref), coverage


def compute_state_metrics(
    sample_projections: dict[str, np.ndarray],
    reference_projections: dict[str, np.ndarray],
    temperature_K: float = 300.0,
    random_seed: int = 42,
    settings: DistributionMetricSettings = DistributionMetricSettings(),
):
    """(state_metric.py:304-374): ``{test_case: {"mae", "rmse",
    "coverage"}}``, then the ``"mean"`` row over the test cases."""
    maes, rmses, covs = {}, {}, {}
    for tc in sample_projections:
        metric = DistributionMetrics2D(
            reference_projections[tc],
            random_seed=random_seed,
            temperature_K=temperature_K,
            n_resample=settings.n_resample,
            sigma_resample=settings.sigma_resample,
            num_bins=settings.num_bins,
            energy_cutoff=settings.energy_cutoff,
            padding=settings.padding,
        )
        maes[tc], rmses[tc], covs[tc] = metric.score_nonzero(sample_projections[tc])

    for d in (maes, rmses, covs):
        d["mean"] = float(np.mean([v for k, v in d.items() if k != "mean"]))
    return {tc: {"mae": maes[tc], "rmse": rmses[tc], "coverage": covs[tc]} for tc in maes}


@dataclass
class MDEmulationResults(BenchmarkResults):
    """(evaluate.py:24-95)"""

    benchmark: Benchmark
    sample_projections: dict[str, np.ndarray]
    metrics: dict[str, dict[str, float]]
    temperature_K: float
    random_seed: int

    def save_results(self, output_dir) -> None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        write_csv(out / "results_metrics.csv",
                  [{"test_case": tc, **row} for tc, row in self.metrics.items()],
                  METRIC_COLUMNS, index="test_case")
        np.savez(out / "results_projections.npz", **self.sample_projections)

    def get_aggregate_metrics(self) -> dict[str, float]:
        return dict(self.metrics["mean"])

    def plot(self, output_dir, max_energy: float = 10.0) -> None:
        """Side-by-side MD-vs-model free-energy surfaces + per-system metric
        strips (eval/md_emulation/plot.py:123-320)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from se3diff_torch.benchmarks import plots

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        refs = load_reference_projections()
        fig = plots.plot_md_projection_grid(
            self.sample_projections,
            {tc: refs[tc] for tc in self.sample_projections},
            temperature_K=self.temperature_K,
            max_energy=max_energy,
        )
        fig.savefig(out / "projections.png", dpi=120)
        plt.close(fig)

        per_case = {tc: dict(row) for tc, row in self.metrics.items() if tc != "mean"}
        label_map = {
            c: {"mae": "MAE (kcal/mol)", "rmse": "RMSE (kcal/mol)"}.get(c, c)
            for c in METRIC_COLUMNS
        }
        fig = plots.plot_metric_strip(per_case, label_map)
        fig.savefig(out / "metrics.png", dpi=120)
        plt.close(fig)


def evaluate_md_emulation(
    indexed_samples: IndexedSamples,
    temperature_K: float = 300.0,
    random_seed: int = 42,
    settings: DistributionMetricSettings = DistributionMetricSettings(),
) -> MDEmulationResults:
    """(evaluate.py:98-150)"""
    reference_projections = load_reference_projections()
    params = load_projection_parameters()

    sample_projections: dict[str, np.ndarray] = {}
    for tc, sss in sorted(indexed_samples.test_case_to_sequencesamples.items()):
        feats = np.concatenate(
            [compute_features(ss.get_traj()) for ss in sss], axis=0
        )
        sample_projections[tc] = project_features(feats, params[tc])

    metrics = compute_state_metrics(
        sample_projections,
        reference_projections,
        temperature_K=temperature_K,
        random_seed=random_seed,
        settings=settings,
    )
    return MDEmulationResults(
        benchmark=Benchmark.MD_EMULATION,
        sample_projections=sample_projections,
        metrics=metrics,
        temperature_K=temperature_K,
        random_seed=random_seed,
    )
