"""Benchmark evaluation suite (multiconf, local unfolding, folding free
energies, MD emulation) — counterpart of ``se3diff_tpu.benchmarks`` and of
the bioemu-benchmarks package. Host-side numpy; no pandas."""

from se3diff_torch.benchmarks.core import ALL_BENCHMARKS, MULTICONF_BENCHMARKS, Benchmark
from se3diff_torch.benchmarks.samples import (
    IndexedSamples,
    SequenceSample,
    filter_unphysical_samples,
    find_samples_in_dir,
)

__all__ = [
    "ALL_BENCHMARKS",
    "MULTICONF_BENCHMARKS",
    "Benchmark",
    "IndexedSamples",
    "SequenceSample",
    "filter_unphysical_samples",
    "find_samples_in_dir",
]
