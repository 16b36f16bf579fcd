"""Frames <-> backbone atom37 coordinates.

Counterpart of ``se3diff_tpu/struct/atoms.py`` (reference
`bioemu/src/bioemu/convert_chemgraph.py:19-293`). N/CA/C/CB are placed
directly from the backbone frame (``global = R @ local + t``) and the
carbonyl O is imputed from adjacent frames, which gives the reference's
group-0 outputs without its 8-rigid-group torsion machinery. The inverse,
:func:`frames_from_backbone`, is host-side numpy for the training data.
"""

from __future__ import annotations

import numpy as np
import torch

from se3diff_torch.struct.residues import (
    ATOM37_C,
    ATOM37_CA,
    ATOM37_CB,
    ATOM37_N,
    ATOM37_O,
    BACKBONE_ATOM_MASK,
    BACKBONE_LOCAL_POSITIONS,
    C_O_BOND_LENGTH,
    sequence_to_aatype,
)

NM_TO_ANG = 10.0


def atom37_mask(aatype) -> np.ndarray:
    """Host-side ``[N, 37]`` atom-existence mask computed from ``aatype``
    alone (identical to the mask :func:`atom37_from_frames` returns)."""
    aatype = np.asarray(aatype)
    local_mask = np.asarray(BACKBONE_ATOM_MASK)[aatype]
    mask = np.zeros((len(aatype), 37), bool)
    mask[:, [ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_O]] = True
    mask[:, ATOM37_CB] = local_mask[:, 3] > 0
    return mask


def atom37_from_frames(
    pos: torch.Tensor, rot: torch.Tensor, aatype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Place idealised backbone atoms from rigid frames.

    Args:
        pos: ``[..., N, 3]`` frame translations in nm (model convention).
        rot: ``[..., N, 3, 3]`` frame rotations.
        aatype: ``[N]`` restype indices, a host array.

    Returns:
        ``atom37 [..., N, 37, 3]`` in Angstroms (N/CA/C/CB/O filled) and
        ``mask [N, 37]`` on the same device (CB absent for GLY).
    """
    aatype = np.asarray(aatype)
    idx = torch.as_tensor(aatype, dtype=torch.long, device=pos.device)
    local = torch.as_tensor(BACKBONE_LOCAL_POSITIONS, dtype=pos.dtype, device=pos.device)[idx]
    local_mask = torch.as_tensor(BACKBONE_ATOM_MASK, device=pos.device)[idx]  # [N, 4]

    global_pos = torch.einsum("...nij,naj->...nai", rot, local) + pos[..., :, None, :] * NM_TO_ANG
    global_pos = global_pos * local_mask[..., None].to(pos.dtype)

    atom37 = global_pos.new_zeros((*global_pos.shape[:-2], 37, 3))
    # local ordering is (N, CA, C, CB).
    atom37[..., [ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_CB], :] = global_pos
    atom37 = adjust_oxygen_pos(atom37)

    mask = torch.as_tensor(atom37_mask(aatype), device=pos.device)
    return atom37, mask


def get_atom37_from_frames(
    pos: torch.Tensor, rot: torch.Tensor, sequence: str
) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """The reference's signature (convert_chemgraph.py:139-185): ``pos [N,
    3]`` nm and ``rot [N, 3, 3]`` of ``sequence`` -> ``(atom37 [N, 37, 3]``
    in Angstroms, ``mask [N, 37]``, ``aatype [N])``."""
    aatype = sequence_to_aatype(sequence)
    atom37, mask = atom37_from_frames(pos, rot, aatype)
    return atom37, mask, aatype


def frames_from_backbone(
    n: np.ndarray, ca: np.ndarray, c: np.ndarray, tol: float = 1e-8
) -> tuple[np.ndarray, np.ndarray]:
    """Rigid frames from global backbone atoms, the inverse of
    :func:`atom37_from_frames`.

    Gram-Schmidt with CA at the origin, C on the +x axis and N in the
    xy-plane (openfold's ``Rigid.from_3_points``, the convention of
    ``BACKBONE_LOCAL_POSITIONS``). Host-side numpy, any leading batch shape.

    Args:
        n, ca, c: ``[..., 3]`` global atom positions in Angstroms.

    Returns:
        ``pos [..., 3]`` frame translations in nm and ``rot [..., 3, 3]``
        rotations (float32), with ``global = R @ local + t``.
    """
    n = np.asarray(n, np.float64)
    ca = np.asarray(ca, np.float64)
    c = np.asarray(c, np.float64)

    def unit(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + tol)

    e1 = unit(c - ca)
    u = n - ca
    e2 = unit(u - np.sum(u * e1, axis=-1, keepdims=True) * e1)
    e3 = np.cross(e1, e2)
    rot = np.stack([e1, e2, e3], axis=-1)  # columns = images of x, y, z
    return (ca / NM_TO_ANG).astype(np.float32), rot.astype(np.float32)


def frames_from_atom37(atom37: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """:func:`frames_from_backbone` on ``[..., N, 37, 3]`` atom37 arrays."""
    atom37 = np.asarray(atom37)
    return frames_from_backbone(
        atom37[..., ATOM37_N, :], atom37[..., ATOM37_CA, :], atom37[..., ATOM37_C, :]
    )


def adjust_oxygen_pos(atom37: torch.Tensor, tol: float = 1e-7) -> torch.Tensor:
    """Impute carbonyl O from adjacent frames (convert_chemgraph.py:214-293).

    Interior residues: O lies in the CA/C/N(next) plane, along the bisector
    of CA->C and N(next)->C, 1.23 A from C. The terminal residue uses the
    bisector of CA->C and CA->N of its own frame. Returns a new tensor.
    """
    ca, c, n = atom37[..., ATOM37_CA, :], atom37[..., ATOM37_C, :], atom37[..., ATOM37_N, :]

    def unit(v):
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + tol)

    o_dir_interior = unit(unit(c[..., :-1, :] - ca[..., :-1, :]) + unit(c[..., :-1, :] - n[..., 1:, :]))
    o_interior = c[..., :-1, :] + o_dir_interior * C_O_BOND_LENGTH
    o_dir_term = unit(unit(c[..., -1:, :] - ca[..., -1:, :]) + unit(n[..., -1:, :] - ca[..., -1:, :]))
    o_term = c[..., -1:, :] + o_dir_term * C_O_BOND_LENGTH

    out = atom37.clone()
    out[..., ATOM37_O, :] = torch.cat([o_interior, o_term], dim=-2)
    return out
