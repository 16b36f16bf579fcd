"""Analysis observables: FNC, rigid alignment, h-functions for PPFT targets.

Counterpart of ``se3diff_tpu/ppft/observables.py`` (reference
`bioemu/src/bioemu/observables.py` and its near-duplicate
`observables_ddr.py`). Native contacts are a dense boolean ``[L, L]`` mask
plus the reference distance matrix; the masked mean over the full grid equals
the reference's mean over its (symmetrized) contact list
(`observables.py:60-113`).

Units follow the reference: model coordinates in nm, contact geometry in
Angstroms (`observables.py:508-513` multiplies by 10). Every function on
coordinates takes tensors and runs on their device; the reference structure
(:func:`load_ref`) and the contact map stay numpy on the host.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from se3diff_torch.struct.cif import read_cif
from se3diff_torch.struct.pdb import read_pdb
from se3diff_torch.struct.residues import ATOM37_CA


@dataclass(frozen=True)
class FNCSettings:
    """Fraction-of-native-contacts settings (observables.py:24-42)."""

    sequence_separation: int = 3
    contact_cutoff: float = 10.0  # Angstrom
    contact_beta: float = 5.0
    contact_delta: float = 0.0
    contact_lambda: float = 1.2


# --------------------------------------------------------------------- #
# Reference loading                                                      #
# --------------------------------------------------------------------- #


@lru_cache(maxsize=16)
def load_ref(structure_file: str) -> np.ndarray:
    """C-alpha coordinates (nm, f32) of a PDB/mmCIF reference, present atoms
    only (observables.py:417-455)."""
    path = str(structure_file)
    if path.endswith(".cif"):
        struct = read_cif(path)
    elif path.endswith(".pdb"):
        struct = read_pdb(path)
    else:
        raise ValueError(f"unsupported reference {structure_file}: give a .cif or .pdb file")
    ca = struct.atom37[0, :, ATOM37_CA, :]  # Angstrom
    present = struct.mask[:, ATOM37_CA].astype(bool)
    return np.asarray(ca[present], np.float32) / 10.0


def _ref_tensor(ref_path: str, like: torch.Tensor) -> tuple[np.ndarray, torch.Tensor]:
    """The reference in nm as numpy and as a tensor on ``like``'s device."""
    ref_nm = load_ref(str(ref_path))
    return ref_nm, torch.from_numpy(ref_nm).to(device=like.device, dtype=like.dtype)


# --------------------------------------------------------------------- #
# Native contacts (dense-mask formulation)                               #
# --------------------------------------------------------------------- #


def reference_contact_map(
    ref_coords_ang: np.ndarray,
    sequence_separation: int = FNCSettings.sequence_separation,
    contact_cutoff: float = FNCSettings.contact_cutoff,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense native-contact mask + reference distances (observables.py:60-113).

    ``ref_coords_ang [L, 3]`` Angstrom -> ``mask [L, L]`` bool (symmetric,
    ``|i-j| > sequence_separation``, within the cutoff; float64 distances)
    and ``dist [L, L]`` f32 reference distances in Angstrom.
    """
    ref = np.asarray(ref_coords_ang, np.float64)
    dist = np.linalg.norm(ref[:, None] - ref[None, :], axis=-1)
    L = ref.shape[0]
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    mask = (sep > sequence_separation) & (dist <= contact_cutoff)
    return mask, dist.astype(np.float32)


def contact_score(
    coords_ang: torch.Tensor,
    ref_dist_ang: torch.Tensor,
    contact_mask: torch.Tensor,
    settings: FNCSettings = FNCSettings(),
) -> torch.Tensor:
    """Soft FNC per sample (observables.py:199-232):
    ``q = mean_c sigmoid(-beta (d_c - lambda (d_ref_c + delta)))`` over the
    contact set; ``coords_ang [B, L, 3]`` -> ``[B]``."""
    d = torch.linalg.vector_norm(
        coords_ang[:, :, None, :] - coords_ang[:, None, :, :] + 1e-12, dim=-1
    )
    q = torch.sigmoid(
        -settings.contact_beta
        * (d - settings.contact_lambda * (ref_dist_ang + settings.contact_delta))
    )
    w = contact_mask.to(q.dtype)
    return (q * w).sum(dim=(-1, -2)) / w.sum().clamp(min=1.0)


def get_fnc_from_coords(
    samples_coords_ang: torch.Tensor,
    reference_coords_ang: np.ndarray,
    settings: FNCSettings = FNCSettings(),
) -> torch.Tensor:
    """FNC of samples against a reference with the same residue ordering
    (observables.py:235-317)."""
    mask, dist = reference_contact_map(
        reference_coords_ang, settings.sequence_separation, settings.contact_cutoff
    )
    device = samples_coords_ang.device
    return contact_score(
        samples_coords_ang,
        torch.from_numpy(dist).to(device=device, dtype=samples_coords_ang.dtype),
        torch.from_numpy(mask).to(device),
        settings,
    )


# --------------------------------------------------------------------- #
# Weighted Kabsch alignment                                              #
# --------------------------------------------------------------------- #


def weighted_rigid_align(
    coords: torch.Tensor,
    ref_coords: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted SVD (Kabsch) alignment of ``coords`` onto ``ref_coords``
    (observables.py:320-415; adapted there from Boltz-1).

    ``coords [B, N, 3]`` or ``[N, 3]``; returns ``coords`` rotated into the
    reference frame and moved to the reference centroid. The determinant fix
    makes the rotation proper, so the result does not depend on the signs
    the SVD picks.
    """
    batched = coords.ndim > 2
    if not batched:
        coords, ref_coords = coords[None], ref_coords[None]
    elif ref_coords.ndim == 2:
        ref_coords = ref_coords[None].expand(coords.shape)

    B, N, dim = coords.shape
    if weights is None:
        weights = torch.ones((B, N), dtype=coords.dtype, device=coords.device)
    elif weights.ndim == 1:
        weights = weights[None].expand(B, N)
    w = weights[..., None]

    c_centroid = (coords * w).sum(1, keepdim=True) / w.sum(1, keepdim=True)
    r_centroid = (ref_coords * w).sum(1, keepdim=True) / w.sum(1, keepdim=True)
    cc = coords - c_centroid
    rc = ref_coords - r_centroid

    cov = torch.einsum("bni,bnj->bij", (w * rc).float(), cc.float())
    U, _, Vh = torch.linalg.svd(cov)
    F = torch.eye(dim, dtype=torch.float32, device=coords.device).repeat(B, 1, 1)
    F[:, -1, -1] = torch.linalg.det(U @ Vh)
    rot = U @ F @ Vh

    aligned = cc @ rot.to(coords.dtype).transpose(-1, -2) + r_centroid
    return aligned if batched else aligned[0]


# --------------------------------------------------------------------- #
# h* targets and h functions                                             #
# --------------------------------------------------------------------- #


def h_star_from_csv(info_path: str) -> tuple[list[str], np.ndarray]:
    """(sequences, h* [n, 2]) from a mutant-scan CSV (observables.py:457-480).

    ``h*[:, 0] = sigmoid(-f_dg_pred)`` (p_folded, Faure et al. 2022 Fig 2),
    ``h*[:, 1] = sigmoid(-b_dg_pred)`` (p_bound). A CSV without one of the
    columns ``seq``, ``f_dg_pred``, ``b_dg_pred`` raises ``KeyError``.
    """
    with open(info_path, newline="", encoding="utf-8-sig") as f:
        rows = list(csv.DictReader(f))
    seqs = [r["seq"] for r in rows]
    h = np.zeros((len(seqs), 2), np.float32)
    for k, col in enumerate(("f_dg_pred", "b_dg_pred")):
        dg = np.array([float(r[col]) for r in rows], np.float64)
        h[:, k] = 1.0 / (1.0 + np.exp(dg))
    return seqs, h


h_star_for_grb2_sh3 = h_star_from_csv  # reference name (observables.py:457)

# Hard fold/bind classification thresholds (observables.py:525-541).
PROTEIN_FOLDED_Q_THRESHOLD = 0.7
LOOP_FOLDED_RMSD_NM = 0.2
LOOP_REGION = slice(6, 21)

# GRB2-SH3 binding-interface residues (observables_ddr.py:598).
SH3_INTERFACE_RESIDUES = (6, 8, 11, 12, 15, 31, 33, 34, 36, 45, 47, 49, 50)


def _rmsd(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x - ref).square().sum(-1).mean(-1))


def compute_h_raw(
    pos_nm: torch.Tensor,
    ref_path: str,
    settings: FNCSettings = FNCSettings(),
) -> torch.Tensor:
    """The soft FNC score and the aligned loop RMSD (nm), unthresholded,
    ``[B, 2]``: what :func:`compute_h_binary` thresholds, for histograms of
    an ensemble (as observations_pdz3.ipynb does for PSD95-PDZ3)."""
    ref_nm, ref = _ref_tensor(ref_path, pos_nm)
    fnc = get_fnc_from_coords(pos_nm * 10.0, ref_nm * 10.0, settings)
    loop = weighted_rigid_align(pos_nm, ref)[:, LOOP_REGION, :]
    return torch.stack([fnc, _rmsd(loop, ref[LOOP_REGION])], dim=-1)


def compute_h_binary(
    pos_nm: torch.Tensor,
    ref_path: str,
    settings: FNCSettings = FNCSettings(),
) -> torch.Tensor:
    """Binary (fold, loop-bound) observables ``[B, 2]``: FNC > 0.7 and
    aligned loop RMSD < 0.2 nm (observables.py:484-541; the same math serves
    GRB2-SH3 and PSD95-PDZ3, :565-622)."""
    fnc, loop_rmsd = compute_h_raw(pos_nm, ref_path, settings).unbind(-1)
    return torch.stack(
        [(fnc > PROTEIN_FOLDED_Q_THRESHOLD).float(), (loop_rmsd < LOOP_FOLDED_RMSD_NM).float()],
        dim=-1,
    )


def compute_h_for_grb2_sh3(pos, node_orientations, ref_path):
    """Reference-signature wrapper (observables.py:484-541)."""
    del node_orientations
    return compute_h_binary(pos, ref_path)


def compute_h_for_grb2_sh3_raw(
    pos: torch.Tensor,
    node_orientations,
    ref_path: str,
    settings: FNCSettings = FNCSettings(),
) -> torch.Tensor:
    """Continuous (FNC score, interface RMSD) observables ``[B, 2]``
    (observables_ddr.py:554-622, minus its stray debug print): the soft
    contact score unthresholded, and the RMSD of the binding-interface
    residues after aligning on the interface."""
    del node_orientations
    ref_nm, ref = _ref_tensor(ref_path, pos)
    fnc = get_fnc_from_coords(pos * 10.0, ref_nm * 10.0, settings)
    idx = list(SH3_INTERFACE_RESIDUES)
    aligned = weighted_rigid_align(pos[:, idx], ref[idx])
    return torch.stack([fnc, _rmsd(aligned, ref[idx])], dim=-1)


def compute_h_for_psd95_pdz3(pos, node_orientations, ref_path):
    """Reference-signature wrapper (observables.py:565-622)."""
    del node_orientations
    return compute_h_binary(pos, ref_path)
