"""Reference structures for the PPFT h-functions.

Counterpart of ``load_ref`` in ``se3diff_tpu/ppft/observables.py``
(reference `observables.py:417-455`): C-alpha coordinates in nm. PDB files
only; the port has no mmCIF reader.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from se3diff_torch.struct.pdb import read_pdb
from se3diff_torch.struct.residues import ATOM37_CA


@lru_cache(maxsize=16)
def load_ref(structure_file: str) -> np.ndarray:
    """C-alpha coordinates (nm, f32) of a PDB reference, present atoms only."""
    if not str(structure_file).endswith(".pdb"):
        raise ValueError(f"unsupported reference {structure_file}: give a .pdb file")
    struct = read_pdb(str(structure_file))
    ca = struct.atom37[0, :, ATOM37_CA, :]  # Angstrom
    present = struct.mask[:, ATOM37_CA].astype(bool)
    return np.asarray(ca[present], np.float32) / 10.0
