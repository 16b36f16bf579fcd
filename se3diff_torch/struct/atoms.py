"""Frames -> backbone atom37 coordinates (batched tensor functions).

Counterpart of ``se3diff_tpu/struct/atoms.py`` (reference
`bioemu/src/bioemu/convert_chemgraph.py:19-293`). N/CA/C/CB are placed
directly from the backbone frame (``global = R @ local + t``) and the
carbonyl O is imputed from adjacent frames, which gives the reference's
group-0 outputs without its 8-rigid-group torsion machinery.
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
