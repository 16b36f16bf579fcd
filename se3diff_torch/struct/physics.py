"""Physicality filtering of sampled backbone structures.

Counterpart of ``se3diff_tpu/struct/physics.py`` (reference
`bioemu/src/bioemu/convert_chemgraph.py:296-395`). Criteria, in Angstroms:

1. CA(i)-CA(i+1) < 4.5 for all sequential pairs,
2. C(i)-N(i+1) < 2.0 for all sequential pairs,
3. closest heavy-atom distance between residues more than 2 apart in
   sequence > 1.0 (no clashes).

:func:`filter_unphysical_masks` is the numpy version;
:func:`filter_unphysical_masks_device` runs on the tensor's device with the
frames in chunks, so the ``[chunk, A, A]`` distance block stays small.
"""

from __future__ import annotations

import numpy as np
import torch

from se3diff_torch.struct.residues import ATOM37_C, ATOM37_CA, ATOM37_N


def filter_unphysical_masks(
    atom37: np.ndarray,
    mask: np.ndarray,
    max_ca_seq_distance: float = 4.5,
    max_cn_seq_distance: float = 2.0,
    clash_distance: float = 1.0,
    sequence_separation: int = 2,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame masks ``[M]`` (ca ok, c-n ok, no clash) for ``atom37 [M, N, 37, 3]``."""
    atom37 = np.asarray(atom37)
    mask = np.asarray(mask, bool)
    M, N = atom37.shape[:2]

    ca = atom37[:, :, ATOM37_CA]
    ok_ca = np.all(np.linalg.norm(ca[:, 1:] - ca[:, :-1], axis=-1) < max_ca_seq_distance, axis=1)
    cn_seq = np.linalg.norm(atom37[:, :-1, ATOM37_C] - atom37[:, 1:, ATOM37_N], axis=-1)
    ok_cn = np.all(cn_seq < max_cn_seq_distance, axis=1)

    valid = np.where(mask.reshape(-1))[0]
    coords_v = atom37.reshape(M, N * 37, 3)[:, valid]
    res_v = np.repeat(np.arange(N), 37)[valid]
    pair_mask = np.abs(res_v[:, None] - res_v[None, :]) > sequence_separation

    ok_clash = np.ones(M, bool)
    if pair_mask.any():
        for m in range(M):
            d = np.linalg.norm(coords_v[m, :, None, :] - coords_v[m, None, :, :], axis=-1)
            ok_clash[m] = bool(np.all(d[pair_mask] > clash_distance))
    return ok_ca, ok_cn, ok_clash


def filter_unphysical_masks_device(
    atom37: torch.Tensor,
    mask: np.ndarray,
    max_ca_seq_distance: float = 4.5,
    max_cn_seq_distance: float = 2.0,
    clash_distance: float = 1.0,
    sequence_separation: int = 2,
    frame_chunk: int = 32,
) -> torch.Tensor:
    """Combined keep mask ``[M]`` (bool, on ``atom37``'s device) with the same
    criteria as :func:`filter_unphysical_masks`. ``mask`` is a host array."""
    mask = np.asarray(mask, bool)
    M, N = atom37.shape[:2]
    dev = atom37.device
    valid_np = np.where(mask.reshape(-1))[0]
    res_v = np.repeat(np.arange(N), 37)[valid_np]
    pair_mask = torch.as_tensor(
        np.abs(res_v[:, None] - res_v[None, :]) > sequence_separation, device=dev
    )
    valid = torch.as_tensor(valid_np, device=dev)

    ca = atom37[:, :, ATOM37_CA]
    ok_ca = (torch.linalg.vector_norm(ca[:, 1:] - ca[:, :-1], dim=-1) < max_ca_seq_distance).all(1)
    cn = torch.linalg.vector_norm(atom37[:, :-1, ATOM37_C] - atom37[:, 1:, ATOM37_N], dim=-1)
    ok_cn = (cn < max_cn_seq_distance).all(1)

    coords_v = atom37.reshape(M, N * 37, 3)[:, valid]
    ok_clash = []
    for c in torch.split(coords_v, frame_chunk):
        d2 = (c[:, :, None] - c[:, None]).square().sum(-1)
        d2 = torch.where(pair_mask, d2, torch.full_like(d2, float("inf")))
        ok_clash.append(d2.amin(dim=(1, 2)) > clash_distance**2)
    return ok_ca & ok_cn & torch.cat(ok_clash)


def get_physical_frame_indices(
    atom37,
    mask: np.ndarray,
    max_ca_seq_distance: float = 4.5,
    max_cn_seq_distance: float = 2.0,
    clash_distance: float = 1.0,
    strict: bool = False,
    device: bool = False,
) -> np.ndarray:
    """Indices of the frames of ``atom37 [M, N, 37, 3]`` that pass all three
    criteria (convert_chemgraph.py:348-371). ``device=True`` runs
    :func:`filter_unphysical_masks_device` on ``atom37``'s device (a
    tensor, or a numpy array taken to the CPU), else the numpy version.
    ``strict`` raises when no frame passes."""
    if device:
        atom37 = torch.as_tensor(atom37)
        matches_all = filter_unphysical_masks_device(
            atom37, mask, max_ca_seq_distance, max_cn_seq_distance, clash_distance
        ).cpu().numpy()
    else:
        ok_ca, ok_cn, ok_clash = filter_unphysical_masks(
            np.asarray(atom37), mask, max_ca_seq_distance, max_cn_seq_distance, clash_distance
        )
        matches_all = ok_ca & ok_cn & ok_clash
    if strict and not matches_all.any():
        raise ValueError("every frame is unphysical: the trajectory would be empty")
    return np.where(matches_all)[0]
