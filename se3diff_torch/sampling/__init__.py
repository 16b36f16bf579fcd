"""Sampling pipeline: bundles, embeddings, orchestration."""

from se3diff_torch.sampling.bundle import (
    Bundle,
    load_bundle,
    make_denoiser,
    maybe_download_checkpoint,
    random_bundle,
    resolve_device,
)
from se3diff_torch.sampling.pipeline import (
    batch_size_heuristic,
    generate_batch,
    generate_batch_async,
    sample,
    stage_conditioning,
    write_structure_outputs,
)

__all__ = [
    "Bundle",
    "load_bundle",
    "make_denoiser",
    "maybe_download_checkpoint",
    "random_bundle",
    "resolve_device",
    "batch_size_heuristic",
    "generate_batch",
    "generate_batch_async",
    "sample",
    "stage_conditioning",
    "write_structure_outputs",
]
