"""Utility layer: step timer, profiles, logger, traceback decorator.

JAX's ``utils/compile_cache.py`` has no counterpart: PyTorch's eager
execution compiles no program to cache, and the port's one build product,
the CUDA kernel library, is cached by
``se3diff_torch.ops.ipa_attention.library_path()``."""

from se3diff_torch.utils.logging import get_logger
from se3diff_torch.utils.profiling import (
    StepTimer,
    print_traceback_on_exception,
    trace_profile,
)

__all__ = [
    "get_logger",
    "StepTimer",
    "print_traceback_on_exception",
    "trace_profile",
]
