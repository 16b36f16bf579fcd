"""Backbone trajectory container (host-side numpy).

Copy of ``se3diff_tpu/benchmarks/trajectory.py``. Ensembles load into dense
``[F, R, 4, 3]`` arrays of backbone atoms in (N, CA, C, O) order (the
reference's mdtraj "backbone" selection, evaluate.py:410-414) with resSeq
bookkeeping, through the port's PDB parser and native XTC codec. The
training data layer (`training/data.py`) reads its ensembles with it.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from se3diff_torch.struct.pdb import Structure, read_pdb
from se3diff_torch.struct.residues import ATOM37_C, ATOM37_CA, ATOM37_N, ATOM37_O

BACKBONE_ATOM37 = np.asarray([ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_O])
CA_IN_BACKBONE = 1  # index of CA within the (N, CA, C, O) layout


@dataclass
class BackboneTraj:
    """``coords [F, R, 4, 3]`` in Angstrom (N, CA, C, O), ``resseq [R]``
    PDB numbering, one-letter ``sequence`` of length R."""

    coords: np.ndarray
    resseq: np.ndarray
    sequence: str

    @property
    def n_frames(self) -> int:
        return self.coords.shape[0]

    @property
    def n_residues(self) -> int:
        return self.coords.shape[1]

    def ca(self) -> np.ndarray:
        return self.coords[:, :, CA_IN_BACKBONE, :]

    def __getitem__(self, idx) -> "BackboneTraj":
        frames = np.atleast_3d(self.coords[idx])
        if frames.ndim == 3:
            frames = frames[None]
        return BackboneTraj(frames, self.resseq, self.sequence)

    def slice_frames(self, idx) -> "BackboneTraj":
        return BackboneTraj(self.coords[idx], self.resseq, self.sequence)

    def select_residues(self, residue_idx: np.ndarray) -> "BackboneTraj":
        residue_idx = np.asarray(residue_idx)
        return BackboneTraj(
            self.coords[:, residue_idx],
            self.resseq[residue_idx],
            "".join(self.sequence[i] for i in residue_idx),
        )

    def resseq_to_index(self) -> dict[int, int]:
        return {int(r): i for i, r in enumerate(self.resseq)}


def traj_from_structure(struct: Structure) -> BackboneTraj:
    """Keep residues with an (N, CA, C) backbone; impute missing carbonyl O.

    Some benchmark reference PDBs (e.g. the folding-dG mutant structures)
    ship without O atoms; O is reconstructed on the CA/C/N(next) bisector at
    1.23 A from C (same rule as struct.atoms.adjust_oxygen_pos).
    """
    has_nca_c = struct.mask[:, BACKBONE_ATOM37[:3]].all(axis=-1)
    keep = np.where(has_nca_c)[0]
    coords = struct.atom37[:, keep][:, :, BACKBONE_ATOM37, :].astype(np.float64)
    missing_o = ~struct.mask[keep, BACKBONE_ATOM37[3]]
    if missing_o.any():
        n, ca, c = coords[:, :, 0], coords[:, :, 1], coords[:, :, 2]

        def unit(v):
            return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)

        o = np.empty_like(c)
        o[:, :-1] = c[:, :-1] + 1.23 * unit(
            unit(c[:, :-1] - ca[:, :-1]) + unit(c[:, :-1] - n[:, 1:])
        )
        o[:, -1:] = c[:, -1:] + 1.23 * unit(
            unit(c[:, -1:] - ca[:, -1:]) + unit(n[:, -1:] - ca[:, -1:])
        )
        coords[:, missing_o, 3] = o[:, missing_o]
    seq = "".join(struct.sequence[i] for i in keep)
    return BackboneTraj(coords, struct.resseq[keep].astype(int), seq)


def load_reference_pdb(path: str | Path) -> BackboneTraj:
    return traj_from_structure(read_pdb(str(path)))


def load_sample_traj(
    trajectory_file: str | Path,
    topology_file: str | Path,
    frame_indices: np.ndarray | None = None,
) -> BackboneTraj:
    """Load a sampled ensemble: ``topology.pdb`` + ``.xtc`` (nm -> Angstrom),
    or a multi-model PDB trajectory."""
    trajectory_file = str(trajectory_file)
    if trajectory_file.endswith(".xtc"):
        from se3diff_torch.struct import xtc

        coords_nm = xtc.read_xtc(trajectory_file)[0]  # [F, A, 3] nm
        coords = np.asarray(coords_nm, np.float64) * 10.0
        # The xtc atom stream must follow the topology's atom37-masked
        # ordering; rebuild per-residue backbone positions from it.
        struct = read_pdb(str(topology_file))
        n_atoms_expected = int(struct.mask.sum())
        if coords.shape[1] != n_atoms_expected:
            raise ValueError(
                f"trajectory has {coords.shape[1]} atoms, topology expects "
                f"{n_atoms_expected}"
            )
        # Scatter flat atoms back into atom37 slots following the
        # topology file's atom order (standard PDBs store O before CB,
        # unlike atom37 slot order).
        F = coords.shape[0]
        atom37 = np.zeros((F, struct.mask.shape[0], 37, 3), np.float64)
        flat_idx = struct.atom_order
        atom37[:, flat_idx[:, 0], flat_idx[:, 1]] = coords
        full = Structure(
            atom37=atom37.astype(np.float32),
            mask=struct.mask,
            aatype=struct.aatype,
            resseq=struct.resseq,
        )
        traj = traj_from_structure(full)
    else:
        traj = traj_from_structure(read_pdb(trajectory_file))
    if frame_indices is not None:
        traj = traj.slice_frames(np.asarray(frame_indices))
    return traj
