"""hpacker sidechain-reconstruction adapter.

Counterpart of `bioemu/src/bioemu/{run_hpacker.py,sidechain_relax.py:44-113,
hpacker_setup/setup_hpacker.py}`: hpacker lives in its own conda environment
and is driven per frame through a subprocess. Environment variables:

* ``HPACKER_ENV_NAME`` (default ``hpacker``)
* ``HPACKER_REPO_DIR`` (default ``~/.se3diff_hpacker``)
* ``HPACKER_PYTHONBIN`` — python binary override (skips conda discovery)

Copy of ``se3diff_tpu/relax/hpacker.py`` on the port's ``struct.pdb``.
"""

from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path
from tempfile import TemporaryDirectory

from se3diff_torch.struct.pdb import Structure, read_pdb, write_pdb

logger = logging.getLogger(__name__)

HPACKER_DEFAULT_ENVNAME = "hpacker"
HPACKER_DEFAULT_REPO_DIR = os.path.join(os.path.expanduser("~"), ".se3diff_hpacker")

# Standalone script executed inside the hpacker env (run_hpacker.py:1-32).
_HPACKER_SCRIPT = """\
import sys
from hpacker import HPacker

hpacker = HPacker(sys.argv[1])
hpacker.reconstruct_sidechains(num_refinement_iterations=5)
hpacker.write_pdb(sys.argv[2])
"""


def get_conda_prefix() -> str:
    """Root conda prefix (utils.py:31-47)."""
    prefix = os.getenv("CONDA_PREFIX_1", os.getenv("CONDA_PREFIX"))
    if prefix is None:
        raise RuntimeError(
            "No conda installation found (CONDA_PREFIX unset); "
            "set HPACKER_PYTHONBIN to the hpacker env's python."
        )
    return prefix


def _hpacker_pythonbin() -> str:
    override = os.getenv("HPACKER_PYTHONBIN")
    if override:
        return override
    envname = os.getenv("HPACKER_ENV_NAME", HPACKER_DEFAULT_ENVNAME)
    return os.path.join(get_conda_prefix(), "envs", envname, "bin", "python")


def run_hpacker(protein_pdb_in: str, protein_pdb_out: str) -> None:
    """Reconstruct sidechains for one backbone PDB via the hpacker env
    (sidechain_relax.py:44-68)."""
    pythonbin = _hpacker_pythonbin()
    if not os.path.exists(pythonbin):
        raise FileNotFoundError(
            f"hpacker python not found at {pythonbin}; install hpacker into "
            "a conda env (HPACKER_ENV_NAME) or set HPACKER_PYTHONBIN."
        )
    result = subprocess.run(
        [pythonbin, "-c", _HPACKER_SCRIPT, protein_pdb_in, protein_pdb_out],
        capture_output=True,
    )
    if result.returncode != 0:
        raise RuntimeError(f"Error running hpacker: {result.stderr.decode()}")


def reconstruct_sidechains(struct: Structure) -> list[Structure]:
    """Per-frame hpacker reconstruction of a backbone-only multi-model
    Structure (sidechain_relax.py:71-113).

    Returns one all-heavy-atom Structure per successfully reconstructed
    frame; frames whose reconstructed topology disagrees with frame 0 are
    skipped with a warning (reference behavior).
    """
    out: list[Structure] = []
    with TemporaryDirectory() as tmp:
        for n in range(struct.num_models):
            pdb_in = os.path.join(tmp, f"frame_{n}_bb.pdb")
            pdb_out = os.path.join(tmp, f"frame_{n}_heavyatom.pdb")
            frame = Structure(
                atom37=struct.atom37[n : n + 1],
                mask=struct.mask,
                aatype=struct.aatype,
                resseq=struct.resseq,
            )
            write_pdb(frame, pdb_in)
            run_hpacker(pdb_in, pdb_out)
            out.append(read_pdb(pdb_out))

    if not out:
        return out
    ref_mask = out[0].mask
    kept = [out[0]]
    for n, frame in enumerate(out[1:], start=1):
        if frame.mask.shape == ref_mask.shape and (frame.mask == ref_mask).all():
            kept.append(frame)
        else:
            logger.warning(
                "skipping frame %d due to different reconstructed topology", n
            )
    return kept
