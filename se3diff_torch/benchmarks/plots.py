"""Publication-style plot library for the benchmark suite.

Counterpart of the reference's `bioemu-benchmarks/bioemu_benchmarks/eval/
multiconf/plot.py` and `eval/md_emulation/plot.py`: 2D free-energy contour
landscapes, smoothed 1D free-energy curves, coverage-bootstrap curves with
confidence bands, side-by-side MD-vs-model surface grids, and per-system
metric strip plots. All functions are matplotlib-only (no seaborn/scipy
dependency); histograms use numpy. Randomized smoothing takes an explicit
``rng`` so figures are reproducible (the reference uses the global
``np.random``, plot.py:263).

Copy of ``se3diff_tpu/benchmarks/plots.py``; matplotlib is imported only
when a figure is drawn.
"""

from __future__ import annotations

import copy
from typing import Mapping

import numpy as np

from se3diff_torch.benchmarks.multiconf import METRICS_SUCCESS_THRESHOLD, MetricType

K_BOLTZMANN = 0.001987203599772605  # kcal / mol / K

# Axis units for figure labels (plot.py:47-48).
METRICS_UNIT: dict[MetricType, str] = {MetricType.RMSD: "(Å)"}


def _use_agg():
    import matplotlib

    matplotlib.use("Agg", force=False)


def free_energy_histogram_2d(
    x: np.ndarray,
    numbins: int = 20,
    x_range: tuple[float, float] | None = None,
    y_range: tuple[float, float] | None = None,
    kT: float = 1.0,
    max_energy: float = 10.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binned -kT ln(count) energy surface over a 2D sample cloud
    (plot.py:83-111, with ``np.histogram2d`` in place of scipy's
    ``binned_statistic_2d`` count mode — identical binning semantics).

    Returns ``(grid_x, grid_y, energy)``; energy is shifted to min 0 and
    clamped at ``max_energy + 1`` so an over-color can mark empty bins.
    """
    x = np.asarray(x)
    if x_range is None:
        x_range = (float(x[:, 0].min()), float(x[:, 0].max()))
    if y_range is None:
        y_range = (float(x[:, 1].min()), float(x[:, 1].max()))
    counts, _, _ = np.histogram2d(
        x[:, 0], x[:, 1], bins=numbins, range=[x_range, y_range]
    )
    grid_1d = np.linspace(x_range[0], x_range[1], numbins)
    grid_x = np.stack([grid_1d] * numbins)
    grid_y = grid_x.T
    # NOTE: like the reference, the (x-binned, y-binned) count matrix is fed
    # to contourf with X varying along rows — both axes use the same grid.
    energy = -np.log(counts + 1e-6)
    energy -= energy.min()
    energy = np.minimum(kT * energy, max_energy + 1.0)
    return grid_x, grid_y, energy


def plot_free_energy(
    x: np.ndarray,
    numbins: int = 20,
    figsize: tuple[int, int] = (5, 5),
    max_energy: float = 10.0,
    levels: int = 20,
    x_range: tuple[float, float] | None = None,
    y_range: tuple[float, float] | None = None,
    cbar: bool = True,
    kT: float = 1.0,
    ax=None,
):
    """2D free-energy contour plot of ``x [n, 2]`` (plot.py:51-127): turbo
    colormap, white over-color for empty bins, optional energy colorbar."""
    _use_agg()
    import matplotlib.pyplot as plt

    if x_range is None:
        x_range = (float(x[:, 0].min()), float(x[:, 0].max()))
    if y_range is None:
        y_range = (float(x[:, 1].min()), float(x[:, 1].max()))
    grid_x, grid_y, energy = free_energy_histogram_2d(
        x, numbins, x_range, y_range, kT=kT, max_energy=max_energy
    )
    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.subplots(1, 1)
        owns_figure = True
    else:
        owns_figure = False
    cmap = copy.copy(plt.cm.turbo)
    cmap.set_over(color="w")
    cf = ax.contourf(
        grid_x, grid_y, energy, cmap=cmap, levels=levels, vmin=0, vmax=max_energy
    )
    ax.set_xlim(*x_range)
    ax.set_ylim(*y_range)
    if cbar and owns_figure:
        cbar_ = ax.figure.colorbar(cf, ax=ax)
        cbar_.ax.set_ylim(0, max_energy)
        cbar_.set_label("Energy (kcal/mol)")
    return ax


def plot_free_energy_with_threshold(
    x: np.ndarray,
    success_threshold: float,
    max_range: float,
    tick_spacing: int | None = 2,
    numbins: int = 20,
    figsize: tuple[int, int] = (5, 5),
    max_energy: float = 10.0,
    levels: int = 20,
    x_range: tuple[float, float] | None = None,
    y_range: tuple[float, float] | None = None,
    cbar: bool = False,
    kT: float = 1.0,
    line_color: str = "black",
    ax=None,
):
    """Square free-energy landscape with dashed success-threshold cross lines
    (plot.py:130-190)."""
    ax = plot_free_energy(
        x,
        numbins=numbins,
        figsize=figsize,
        max_energy=max_energy,
        levels=levels,
        x_range=x_range,
        y_range=y_range,
        cbar=cbar,
        kT=kT,
        ax=ax,
    )
    ax.axhline(y=success_threshold, color=line_color, linestyle="--")
    ax.axvline(x=success_threshold, color=line_color, linestyle="--")
    if tick_spacing is not None:
        ax.set_xticks(np.arange(0, max_range, tick_spacing))
        ax.set_yticks(np.arange(0, max_range, tick_spacing))
    return ax


def plot_2d_free_energy_landscapes_in_grid(
    results: Mapping[str, np.ndarray],
    metric: MetricType,
    numbins: int = 50,
    max_range_multiplier: float = 2.0,
    success_threshold: float | None = None,
):
    """Grid of metric-vs-ref0 x metric-vs-ref1 landscapes, one per system
    (plot.py:193-240). ``results[tc]`` is ``[n_samples, 2]``: the metric of
    each sample against the two conformations. The plot range auto-scales to
    the metric value of the sample closest to each reference."""
    _use_agg()
    import matplotlib.pyplot as plt

    if success_threshold is None:
        success_threshold = METRICS_SUCCESS_THRESHOLD[metric]
    systems = sorted(results.keys())
    n = len(systems)
    nrow = int(np.ceil(n / 3.0))
    fig, axes = plt.subplots(nrow, 3, figsize=(10, 1.5 * n), squeeze=False)
    axes = axes.T.flatten()
    for i, s in enumerate(systems):
        x = np.asarray(results[s])
        d = max(x[np.argmin(x[:, 0]), 1], x[np.argmin(x[:, 1]), 0])
        max_range = max_range_multiplier * d
        plot_free_energy_with_threshold(
            x,
            success_threshold,
            numbins=numbins,
            max_range=max_range,
            levels=20,
            max_energy=10,
            x_range=(0, max_range),
            y_range=(0, max_range),
            ax=axes[i],
            line_color="red",
            tick_spacing=None,
        )
        axes[i].set_title(s)
    for ax in axes[n:]:
        ax.axis("off")
    return fig


def smoothed_1d_free_energy(
    x: np.ndarray,
    noise: float = 0.025,
    value_range: tuple[float, float] = (0, 1),
    bins: int = 100,
    noise_amplification: int = 1000,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian-smoothed -ln p over a 1D observable (plot.py:243-266): each
    point is replicated ``noise_amplification`` times with Gaussian jitter
    before histogramming (a cheap KDE)."""
    if rng is None:
        rng = np.random.default_rng(0)
    x = np.asarray(x, np.float64).ravel()
    x_noised = (
        x[:, None] + noise * rng.standard_normal((x.shape[0], noise_amplification))
    ).ravel()
    hist, bin_edges = np.histogram(x_noised, bins=bins, range=value_range, density=True)
    centers = 0.5 * (bin_edges[:-1] + bin_edges[1:])
    with np.errstate(divide="ignore"):
        return centers, -np.log(hist)


def plot_smoothed_1d_free_energy(
    x: np.ndarray,
    noise: float = 0.025,
    value_range: tuple[float, float] = (0, 1),
    bins: int = 100,
    noise_amplification: int = 1000,
    kT: float = 0.6,
    color: str = "black",
    ax=None,
    rng: np.random.Generator | None = None,
):
    """Filled 1D free-energy curve (plot.py:269-308); non-finite bins are
    raised to just above the finite maximum."""
    _use_agg()
    import matplotlib.pyplot as plt

    centers, y = smoothed_1d_free_energy(
        x, noise=noise, value_range=value_range, bins=bins,
        noise_amplification=noise_amplification, rng=rng,
    )
    y = kT * y
    finite = np.isfinite(y)
    y[~finite] = y[finite].max() + 0.1
    ymin = np.floor(y.min() - 1.0)
    if ax is None:
        plt.figure(figsize=(5, 4))
        ax = plt.gca()
    ax.plot(centers, y, color=color, linewidth=3)
    ax.fill_between(centers, ymin, y, color=color, alpha=0.2)
    ax.set_xlim(*value_range)
    ax.set_ylim(ymin, y.max() - 0.1)
    return ax


def plot_free_energy_landscapes_by_fnc_in_grid(results: Mapping[str, np.ndarray]):
    """Grid of smoothed FNC free-energy curves, one per system
    (plot.py:311-334); for the unfolding benchmarks."""
    _use_agg()
    import matplotlib.pyplot as plt

    systems = sorted(results.keys())
    n = len(systems)
    nrow = int(np.ceil(n / 3.0))
    fig, axes = plt.subplots(nrow, 3, figsize=(10, 1.5 * n), squeeze=False)
    axes = axes.T.flatten()
    for i, s in enumerate(systems):
        plot_smoothed_1d_free_energy(np.asarray(results[s]), ax=axes[i])
        axes[i].set_title(s)
        if i <= n // 3:
            axes[i].set_ylabel("free energy (kcal/mol)")
        if (i - 1) == (n // 3) * 2:
            axes[i].set_xlabel("fraction of native contacts")
    for ax in axes[n:]:
        ax.axis("off")
    return fig


def plot_coverage_bootstrap(
    thresholds: np.ndarray,
    coverages: np.ndarray,
    metric_type: MetricType,
    nsigma: int = 1,
    color: str = "black",
    label: str | None = None,
    ax=None,
    success_threshold: float | None = None,
) -> float:
    """Coverage-vs-threshold curve with a ±nsigma bootstrap band and dashed
    lines at the success threshold (plot.py:337-397). ``coverages`` is
    ``[n_bootstrap, n_thresholds]``; returns the mean coverage at the
    threshold."""
    _use_agg()
    import matplotlib.pyplot as plt

    if success_threshold is None:
        success_threshold = METRICS_SUCCESS_THRESHOLD[metric_type]
    mean = coverages.mean(axis=0)
    std = coverages.std(axis=0)
    if ax is None:
        ax = plt.gca()
    ax.plot(thresholds, mean, color=color, linewidth=1.5, label=label)
    ax.fill_between(
        thresholds,
        np.maximum(0, mean - nsigma * std),
        np.minimum(1, mean + nsigma * std),
        color=color,
        alpha=0.2,
    )
    i = int(np.argmin(np.abs(thresholds - success_threshold)))
    ax.plot([thresholds[i]] * 2, [0, mean[i]], color=color, ls="--", lw=1)
    ax.plot([0, thresholds[i]], [mean[i]] * 2, color=color, ls="--", lw=1)
    ax.set_xlim(0, thresholds[-1])
    ax.set_ylim(0, 1.05)
    return float(mean[i])


def plot_md_projection_grid(
    sample_projections: Mapping[str, np.ndarray],
    reference_projections: Mapping[str, np.ndarray],
    num_bins: int = 40,
    temperature_K: float = 300.0,
    max_energy: float = 10.0,
    levels: int = 10,
):
    """Side-by-side MD-reference vs model free-energy surfaces per system
    (md_emulation/plot.py:123-226): shared axis ranges with a 0.5 buffer,
    shared colorbar column, kT from the evaluation temperature."""
    _use_agg()
    import matplotlib.pyplot as plt
    from matplotlib.ticker import FormatStrFormatter

    kBT = K_BOLTZMANN * temperature_K
    names = sorted(sample_projections.keys())
    n = len(names)
    fig, axs = plt.subplots(
        n, 3, figsize=(6, 2.55 * n), squeeze=False,
        gridspec_kw={"width_ratios": [1, 1, 0.05]},
    )
    cmap = None
    for row, tc in enumerate(names):
        ref = np.asarray(reference_projections[tc])
        smp = np.asarray(sample_projections[tc])
        both = np.concatenate([ref, smp], axis=0)
        span = both.max(axis=0) - both.min(axis=0)
        lo = both.min(axis=0) - 0.5 * span * 0.1
        hi = both.max(axis=0) + 0.5 * span * 0.1
        x_range, y_range = (lo[0], hi[0]), (lo[1], hi[1])
        ax = axs[row]
        ax[0].sharex(ax[1])
        ax[0].sharey(ax[1])
        ax[1].tick_params(labelleft=False)
        import copy as _copy

        cmap = _copy.copy(plt.cm.turbo)
        cmap.set_over(color="w")
        last_cf = None
        for col, pts in ((0, ref), (1, smp)):
            gx, gy, e = free_energy_histogram_2d(
                pts, num_bins, x_range, y_range, kT=kBT, max_energy=max_energy
            )
            last_cf = ax[col].contourf(
                gx, gy, e, cmap=cmap, levels=levels, vmin=0, vmax=max_energy
            )
            ax[col].set_xlim(*x_range)
            ax[col].set_ylim(*y_range)
            ax[col].xaxis.set_major_formatter(FormatStrFormatter("%4.1f"))
            ax[col].yaxis.set_major_formatter(FormatStrFormatter("%4.1f"))
        fig.colorbar(last_cf, cax=ax[2], label="Energy (kcal/mol)")
        ax[0].set_title("MD reference")
        ax[0].set_ylabel(tc)
        ax[1].set_title(f"model ({smp.shape[0]} samples)")
    fig.tight_layout()
    return fig


def plot_metric_strip(
    metrics: Mapping[str, Mapping[str, float]],
    label_map: Mapping[str, str],
    energy_hline: float | None = 1.0,
    energy_metrics: tuple[str, ...] = ("mae", "rmse"),
):
    """Per-system metric strip plot (md_emulation/plot.py:227-320, rebuilt
    without the seaborn dependency): one row per metric, one dot per test
    case, a grey limit line on energy metrics.

    ``metrics[test_case][column] = value``; ``label_map`` orders and labels
    the plotted columns.
    """
    _use_agg()
    import matplotlib.pyplot as plt

    cases = sorted(metrics.keys())
    cols = list(label_map.keys())
    fig, axes = plt.subplots(
        len(cols), 1, figsize=(9, 1.85 * len(cols) + 1.0), squeeze=False, sharex=True
    )
    xs = np.arange(len(cases))
    for ax, col in zip(axes[:, 0], cols):
        vals = np.asarray([metrics[tc].get(col, np.nan) for tc in cases], np.float64)
        ax.scatter(xs, vals, s=45, color="k", zorder=3)
        top = np.nanmax(vals) if np.isfinite(vals).any() else 1.0
        ax.set_ylim(0, top * 1.2)
        ax.xaxis.grid(True)
        ax.set_ylabel(label_map[col])
        ax.yaxis.set_label_position("right")
        ax.yaxis.tick_right()
        if energy_hline is not None and col in energy_metrics:
            ax.axhline(energy_hline, linewidth=0.5, color="grey")
    axes[-1, 0].set_xticks(xs)
    axes[-1, 0].set_xticklabels(cases, rotation=90)
    fig.tight_layout()
    return fig
