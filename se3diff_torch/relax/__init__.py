"""Post-processing: sidechain reconstruction (hpacker) + MD relax (OpenMM).

Counterpart of the reference's L9 layer (`bioemu/src/bioemu/
{sidechain_relax,md_utils,run_hpacker}.py`). Both external tools run as
host-side adapters: hpacker through a subprocess into its own conda env,
OpenMM through a lazily-imported module — each raising an informative error
when unavailable, and mockable in tests exactly like the reference's test
strategy (SURVEY.md section 4.1). Counterpart of ``se3diff_tpu.relax``; MD
runs on OpenMM's CUDA platform unless the caller asks for the CPU.
"""

from se3diff_torch.relax.hpacker import reconstruct_sidechains, run_hpacker
from se3diff_torch.relax.md import MDProtocol, get_platform, run_all_md, run_one_md

__all__ = [
    "MDProtocol",
    "get_platform",
    "reconstruct_sidechains",
    "run_hpacker",
    "run_all_md",
    "run_one_md",
]
