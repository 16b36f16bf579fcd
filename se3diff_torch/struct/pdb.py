"""Minimal PDB read/write for backbone atom37 structures.

Replaces the reference's mdtraj/openfold-Protein serialization path
(`convert_chemgraph.py:398-488`, `openfold/np/protein.py`) with a
self-contained implementation: the environment has no mdtraj/BioPython, so
both the sampling pipeline's topology output and the benchmark suite's
reference-structure loading go through this module.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from se3diff_torch.struct.residues import (
    ATOM37_ELEMENTS,
    ATOM37_NAMES,
    RESTYPE_1TO3,
    RESTYPE_3TO1,
    RESTYPES,
)


@dataclass
class Structure:
    """A (possibly multi-model) protein structure in atom37 layout.

    ``atom37 [M, N, 37, 3]`` Angstroms, ``mask [N, 37]`` bool,
    ``aatype [N]`` int restype indices, ``bfactor [N]`` optional.
    """

    atom37: np.ndarray
    mask: np.ndarray
    aatype: np.ndarray
    chain_id: str = "A"
    bfactor: np.ndarray | None = None
    resseq: np.ndarray | None = None  # PDB residue numbers [N]; default 1..N
    # File-encounter order of present atoms as (residue_idx, atom37_slot)
    # rows [A, 2]; flat coordinate streams (XTC) follow THIS order, which for
    # standard PDBs (N, CA, C, O, CB...) differs from atom37 slot order.
    atom_order: np.ndarray | None = None

    def __post_init__(self):
        if self.resseq is None:
            self.resseq = np.arange(1, self.atom37.shape[1] + 1, dtype=np.int32)
        if self.atom_order is None:
            self.atom_order = np.argwhere(self.mask)

    @property
    def num_models(self) -> int:
        return self.atom37.shape[0]

    @property
    def num_residues(self) -> int:
        return self.atom37.shape[1]

    @property
    def sequence(self) -> str:
        return "".join(RESTYPES[i] for i in self.aatype)


def to_pdb(struct: Structure) -> str:
    """Serialize to PDB text (ATOM records; MODEL blocks if multi-model).

    Coordinates are clamped to the format's fixed 8-column field
    (+-999.999..9999.999); values outside it (garbage models) would shift
    every following column and corrupt the record.
    """
    out = io.StringIO()
    coords_all = struct.atom37
    if np.any(coords_all > 9999.999) or np.any(coords_all < -999.999):
        import logging

        logging.getLogger(__name__).warning(
            "PDB coordinates exceed the fixed-width field; clamping."
        )
        coords_all = np.clip(coords_all, -999.999, 9999.999)
    multi = struct.num_models > 1
    for m in range(struct.num_models):
        if multi:
            out.write(f"MODEL     {m + 1:4d}\n")
        serial = 1
        for i in range(struct.num_residues):
            res3 = RESTYPE_1TO3[RESTYPES[struct.aatype[i]]]
            b = 0.0 if struct.bfactor is None else float(struct.bfactor[i])
            for a in range(37):
                if not struct.mask[i, a]:
                    continue
                name = ATOM37_NAMES[a]
                x, y, z = coords_all[m, i, a]
                pad_name = f" {name:<3s}" if len(name) < 4 else name
                out.write(
                    f"ATOM  {serial:5d} {pad_name}{'':1s}{res3:>3s} "
                    f"{struct.chain_id:1s}{int(struct.resseq[i]):4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{b:6.2f}"
                    f"          {ATOM37_ELEMENTS[a]:>2s}\n"
                )
                serial += 1
        out.write("TER\n")
        if multi:
            out.write("ENDMDL\n")
    out.write("END\n")
    return out.getvalue()


def write_pdb(struct: Structure, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_pdb(struct))


_ATOM37_INDEX = {n: i for i, n in enumerate(ATOM37_NAMES)}


def from_pdb_string(pdb_str: str, chain_id: str | None = None) -> Structure:
    """Parse ATOM records into a Structure (heavy atoms in atom37 layout).

    Multi-model files produce ``atom37 [M, N, 37, 3]``. Unknown residues or
    atoms outside the atom37 vocabulary are skipped. ``chain_id=None`` takes
    the first chain encountered.
    """
    models: list[dict[tuple[str, int], dict[str, tuple]]] = []
    current: dict = {}
    res_order: list[tuple[str, int]] = []
    res_names: dict[tuple[str, int], str] = {}
    chosen_chain = chain_id

    def flush():
        nonlocal current
        if current:
            models.append(current)
            current = {}

    for line in pdb_str.splitlines():
        rec = line[:6]
        if rec == "MODEL ":
            flush()
        elif rec in ("ATOM  ", "HETATM"):
            if rec == "HETATM":
                continue
            ch = line[21]
            if chosen_chain is None:
                chosen_chain = ch
            if ch != chosen_chain:
                continue
            res3 = line[17:20].strip()
            if res3 not in RESTYPE_3TO1:
                continue
            atom_name = line[12:16].strip()
            if atom_name not in _ATOM37_INDEX:
                continue
            resseq = int(line[22:26])
            icode = line[26].strip()
            key = (icode, resseq)
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            current.setdefault(key, {})[atom_name] = xyz
            if not models and key not in res_names:
                res_order.append(key)
            res_names[key] = res3
        elif rec == "ENDMDL":
            flush()
    flush()

    if not models or not res_order:
        raise ValueError("no parsable ATOM records found")

    n_res = len(res_order)
    n_models = len(models)
    res_index = {key: i for i, key in enumerate(res_order)}
    atom37 = np.zeros((n_models, n_res, 37, 3), np.float32)
    mask = np.zeros((n_res, 37), bool)
    aatype = np.zeros((n_res,), np.int32)
    resseq = np.asarray([key[1] for key in res_order], np.int32)
    atom_order: list[tuple[int, int]] = []
    for i, key in enumerate(res_order):
        aatype[i] = RESTYPES.index(RESTYPE_3TO1[res_names[key]])
        for m, model in enumerate(models):
            for atom_name, xyz in model.get(key, {}).items():
                a = _ATOM37_INDEX[atom_name]
                atom37[m, i, a] = xyz
                if m == 0:
                    mask[i, a] = True
                    atom_order.append((i, a))

    return Structure(
        atom37=atom37, mask=mask, aatype=aatype, chain_id=chosen_chain or "A",
        resseq=resseq, atom_order=np.asarray(atom_order, np.int64),
    )


def read_pdb(path: str, chain_id: str | None = None) -> Structure:
    with open(path) as f:
        return from_pdb_string(f.read(), chain_id)
