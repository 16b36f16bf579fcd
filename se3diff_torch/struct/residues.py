"""Amino-acid constants and idealized backbone geometry.

The numeric tables are standard AlphaFold2 idealized residue geometry
(Jumper et al. 2021, supplementary Table 2 lineage; the same physical
constants the reference vendors via openfold
`bioemu/src/bioemu/openfold/np/residue_constants.py`). Only the backbone
rigid-group atoms (N, CA, C, CB) are needed here: the carbonyl oxygen is
always re-imputed from adjacent frames (convert_chemgraph.py:214-293), so
side-chain rigid groups never enter the backbone output path.

Coordinates are in Angstroms, in the local backbone frame (CA at origin,
C on +x, N in the xy-plane).
"""

from __future__ import annotations

import numpy as np

# One-letter codes in the standard AF2 ordering (restype_order).
RESTYPES = [
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I",
    "L", "K", "M", "F", "P", "S", "T", "W", "Y", "V",
]
RESTYPE_ORDER: dict[str, int] = {r: i for i, r in enumerate(RESTYPES)}
UNK_RESTYPE_INDEX = 0  # unknown residues map to ALA, like the reference

RESTYPE_1TO3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}
RESTYPE_3TO1 = {v: k for k, v in RESTYPE_1TO3.items()}

# atom37 heavy-atom ordering (AF2 convention). Backbone slots:
# 0=N, 1=CA, 2=C, 3=CB, 4=O.
ATOM37_NAMES = [
    "N", "CA", "C", "CB", "O", "CG", "CG1", "CG2", "OG", "OG1", "SG", "CD",
    "CD1", "CD2", "ND1", "ND2", "OD1", "OD2", "SD", "CE", "CE1", "CE2",
    "CE3", "NE", "NE1", "NE2", "OE1", "OE2", "CH2", "NH1", "NH2", "OH",
    "CZ", "CZ2", "CZ3", "NZ", "OXT",
]
ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_CB, ATOM37_O = 0, 1, 2, 3, 4

# Idealized local positions of (N, CA, C, CB) in the backbone frame per
# residue type, Angstroms. GLY has no CB (NaN row, masked out).
_NAN3 = (np.nan, np.nan, np.nan)
_BACKBONE_LOCAL = {
    "ALA": [(-0.525, 1.363, 0.0), (0.0, 0.0, 0.0), (1.526, 0.0, 0.0), (-0.529, -0.774, -1.205)],
    "ARG": [(-0.524, 1.362, 0.0), (0.0, 0.0, 0.0), (1.525, 0.0, 0.0), (-0.524, -0.778, -1.209)],
    "ASN": [(-0.536, 1.357, 0.0), (0.0, 0.0, 0.0), (1.526, 0.0, 0.0), (-0.531, -0.787, -1.200)],
    "ASP": [(-0.525, 1.362, 0.0), (0.0, 0.0, 0.0), (1.527, 0.0, 0.0), (-0.526, -0.778, -1.208)],
    "CYS": [(-0.522, 1.362, 0.0), (0.0, 0.0, 0.0), (1.524, 0.0, 0.0), (-0.519, -0.773, -1.212)],
    "GLN": [(-0.526, 1.361, 0.0), (0.0, 0.0, 0.0), (1.526, 0.0, 0.0), (-0.525, -0.779, -1.207)],
    "GLU": [(-0.528, 1.361, 0.0), (0.0, 0.0, 0.0), (1.526, 0.0, 0.0), (-0.526, -0.781, -1.207)],
    "GLY": [(-0.572, 1.337, 0.0), (0.0, 0.0, 0.0), (1.517, 0.0, 0.0), _NAN3],
    "HIS": [(-0.527, 1.360, 0.0), (0.0, 0.0, 0.0), (1.525, 0.0, 0.0), (-0.525, -0.778, -1.208)],
    "ILE": [(-0.493, 1.373, 0.0), (0.0, 0.0, 0.0), (1.527, 0.0, 0.0), (-0.536, -0.793, -1.213)],
    "LEU": [(-0.520, 1.363, 0.0), (0.0, 0.0, 0.0), (1.525, 0.0, 0.0), (-0.522, -0.773, -1.214)],
    "LYS": [(-0.526, 1.362, 0.0), (0.0, 0.0, 0.0), (1.526, 0.0, 0.0), (-0.524, -0.778, -1.208)],
    "MET": [(-0.521, 1.364, 0.0), (0.0, 0.0, 0.0), (1.525, 0.0, 0.0), (-0.523, -0.776, -1.210)],
    "PHE": [(-0.518, 1.363, 0.0), (0.0, 0.0, 0.0), (1.524, 0.0, 0.0), (-0.525, -0.776, -1.212)],
    "PRO": [(-0.566, 1.351, 0.0), (0.0, 0.0, 0.0), (1.527, 0.0, 0.0), (-0.546, -0.611, -1.293)],
    "SER": [(-0.529, 1.360, 0.0), (0.0, 0.0, 0.0), (1.525, 0.0, 0.0), (-0.518, -0.777, -1.211)],
    "THR": [(-0.517, 1.364, 0.0), (0.0, 0.0, 0.0), (1.526, 0.0, 0.0), (-0.516, -0.793, -1.215)],
    "TRP": [(-0.521, 1.363, 0.0), (0.0, 0.0, 0.0), (1.525, 0.0, 0.0), (-0.523, -0.776, -1.212)],
    "TYR": [(-0.522, 1.362, 0.0), (0.0, 0.0, 0.0), (1.524, 0.0, 0.0), (-0.522, -0.776, -1.213)],
    "VAL": [(-0.494, 1.373, 0.0), (0.0, 0.0, 0.0), (1.527, 0.0, 0.0), (-0.533, -0.795, -1.213)],
}

# [20, 4, 3] local positions of (N, CA, C, CB) per restype; NaN for GLY's CB.
BACKBONE_LOCAL_POSITIONS = np.asarray(
    [_BACKBONE_LOCAL[RESTYPE_1TO3[r]] for r in RESTYPES], dtype=np.float32
)
# [20, 4] mask: which of (N, CA, C, CB) exists (CB missing for GLY).
BACKBONE_ATOM_MASK = ~np.isnan(BACKBONE_LOCAL_POSITIONS[..., 0])
BACKBONE_LOCAL_POSITIONS = np.nan_to_num(BACKBONE_LOCAL_POSITIONS)

C_O_BOND_LENGTH = 1.23  # Angstroms (convert_chemgraph.py:16)

# PDB element symbol per atom37 slot (first character of the name, with the
# two-letter names still starting with their element letter).
ATOM37_ELEMENTS = [name[0] for name in ATOM37_NAMES]


def sequence_to_aatype(sequence: str) -> np.ndarray:
    """Map a one-letter sequence to restype indices; unknowns -> ALA (0)."""
    return np.asarray(
        [RESTYPE_ORDER.get(c, UNK_RESTYPE_INDEX) for c in sequence], dtype=np.int32
    )
