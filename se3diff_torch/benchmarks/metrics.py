"""Structural metrics: RMSD, TM-score, DSSP accuracy, LDDT, contacts.

From-scratch counterparts of
`bioemu-benchmarks/bioemu_benchmarks/eval/multiconf/metrics.py`, with the
external native dependencies replaced:

* mdtraj QCP RMSD -> Kabsch (align.rmsd_optimal)
* USalign TM-score subprocess -> native iterative TM-score
  (align.tm_score_fixed_pairing); a USalign adapter remains for hosts that
  have the binary
* mdtraj DSSP (C library) -> from-scratch Kabsch–Sander hydrogen-bond DSSP
  (simplified 3-class H/E/C output, matching mdtraj's ``simplified=True``)

Counterpart of ``se3diff_tpu/benchmarks/metrics.py``, equal to it number for
number. Three of its Python loops are array operations here, with the same
results: the DSSP bridges and turns (booleans), the contact pairs (the same
pairs in the same order) and the per-residue counts of mismatched contacts
(sums of 0/1 values, exact in any order).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import numpy as np

from se3diff_torch.benchmarks.align import (
    matching_positions,
    rmsd_optimal_native,
    superpose,
    tm_d0,
    tm_score_fixed_pairing_batch,
)
from se3diff_torch.benchmarks.trajectory import CA_IN_BACKBONE, BackboneTraj

# ------------------------------------------------------------------ #
# Residue matching                                                    #
# ------------------------------------------------------------------ #


def matching_resids(traj_i: BackboneTraj, traj_j: BackboneTraj) -> list[tuple[int, int]]:
    """Pairs of matching resSeq ids via global sequence alignment
    (align.py:109-137 in the reference uses Biopython globalxx)."""
    pairs = matching_positions(traj_i.sequence, traj_j.sequence)
    return [(int(traj_i.resseq[a]), int(traj_j.resseq[b])) for a, b in pairs]


def _indices_for(traj: BackboneTraj, resids: list[int]) -> np.ndarray:
    m = traj.resseq_to_index()
    return np.asarray([m[r] for r in resids], int)


# ------------------------------------------------------------------ #
# RMSD / TM                                                            #
# ------------------------------------------------------------------ #


def rmsd(
    ref: BackboneTraj, sample: BackboneTraj, pairs: list[tuple[int, int]]
) -> np.ndarray:
    """Optimal backbone RMSD (Angstrom) per sample frame vs ref frame 0
    (evaluate.py:236-249)."""
    ri = _indices_for(ref, [p[0] for p in pairs])
    si = _indices_for(sample, [p[1] for p in pairs])
    target = ref.coords[0, ri].reshape(-1, 3)
    mobile = sample.coords[:, si].reshape(sample.n_frames, -1, 3)
    return rmsd_optimal_native(mobile, target)


def tm_score(
    ref: BackboneTraj, sample: BackboneTraj, pairs: list[tuple[int, int]]
) -> np.ndarray:
    """TM-score per frame over matched CA atoms (metrics.py:20-45).

    The reference runs USalign per frame and takes max(TM_i, TM_j) of the
    two normalizations; here we compute the fixed-pairing TM under both
    normalizations natively (alignment-free pairs come from the sequence
    alignment, which is what USalign converges to for these highly similar
    chains).
    """
    ri = _indices_for(ref, [p[0] for p in pairs])
    si = _indices_for(sample, [p[1] for p in pairs])
    ref_ca = ref.coords[0, ri, CA_IN_BACKBONE]
    sam_all = sample.coords[:, si, CA_IN_BACKBONE]
    # Normalization i batches all frames against the fixed reference; j
    # swaps roles per frame (the target changes, so it cannot batch).
    tm_i = tm_score_fixed_pairing_batch(sam_all, ref_ca)
    tm_j = np.array([
        float(tm_score_fixed_pairing_batch(ref_ca, sam_all[f]))
        for f in range(sample.n_frames)
    ])
    return np.maximum(tm_i, tm_j)


def tm_score_local(pairwise_distances: np.ndarray) -> np.ndarray:
    """Local-region TM from per-atom deviations [F, n_res*4]
    (metrics.py:48-65): CA deviations are every 4th column starting at 1."""
    assert pairwise_distances.ndim == 2
    ca = pairwise_distances[:, CA_IN_BACKBONE::4]
    ltarget = ca.shape[1]
    d0 = 1.24 * np.cbrt(ltarget - 15) - 1.8
    return np.mean(1.0 / (1.0 + (ca / d0) ** 2), axis=-1)


def tm_score_usalign(
    ref_pdb: str, sample_pdb: str, us_align_exec: str | None = None
) -> float:
    """Optional USalign subprocess adapter (align.py:42-81). Raises
    FileNotFoundError when the binary is unavailable (no auto-download in
    hermetic environments)."""
    exe = us_align_exec or shutil.which("USalign")
    if exe is None or not os.path.exists(exe):
        raise FileNotFoundError("USalign binary not found")
    res = subprocess.run(
        [exe, sample_pdb, ref_pdb, "-outfmt", "2"],
        capture_output=True, check=True,
    )
    line = res.stdout.decode().splitlines()[1].split()
    return max(float(line[2]), float(line[3]))


# ------------------------------------------------------------------ #
# DSSP (from scratch, Kabsch–Sander)                                  #
# ------------------------------------------------------------------ #

_Q1Q2_F = 0.084 * 332.0  # kcal/mol, Kabsch & Sander (1983)
_HB_CUTOFF = -0.5


def _hbond_matrix(coords: np.ndarray) -> np.ndarray:
    """Kabsch–Sander backbone H-bonds for one frame ``[R, 4, 3]``.

    ``hb[d, a]`` True when the N-H of residue d donates to the C=O of
    residue a. The amide H is placed 1.01 A from N along the previous
    residue's C->O opposite direction (standard DSSP reconstruction).
    """
    N, CA, C, O = coords[:, 0], coords[:, 1], coords[:, 2], coords[:, 3]
    R = coords.shape[0]
    co = C[:-1] - O[:-1]
    co /= np.linalg.norm(co, axis=-1, keepdims=True) + 1e-12
    H = N.copy()
    H[1:] = N[1:] + 1.01 * co  # residue 0 (no preceding C=O) keeps H = N

    def dist(a, b):
        # [d, a] distances between donor-side atoms and acceptor-side atoms.
        return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1) + 1e-9

    r_ON = dist(N, O)  # |N_d - O_a|
    r_CH = dist(H, C)  # |H_d - C_a|
    r_OH = dist(H, O)  # |H_d - O_a|
    r_CN = dist(N, C)  # |N_d - C_a|
    E = _Q1Q2_F * (1.0 / r_ON + 1.0 / r_CH - 1.0 / r_OH - 1.0 / r_CN)
    hb = E < _HB_CUTOFF
    np.fill_diagonal(hb, False)
    hb[0] = False  # first residue has no amide H
    return hb


def dssp_simplified(traj: BackboneTraj) -> np.ndarray:
    """3-class secondary structure ('H'/'E'/'C') per frame and residue.

    From-scratch DSSP variant: n-turns from i+3/4/5 H-bonds give G/H/I
    helices (all mapped to 'H'), Kabsch–Sander bridges give 'E', the rest
    'C' — the same simplification mdtraj applies to full DSSP output
    (metrics.py:70-106 compares these classes for agreement).
    """
    F, R = traj.n_frames, traj.n_residues
    out = np.full((F, R), "C", dtype="U1")
    for f in range(F):
        hb = _hbond_matrix(traj.coords[f])
        ss = out[f]

        # Bridges -> E, for residue pairs i < j with |i-j| >= 3 (1-based i, j
        # into the padded matrix). Antiparallel: hb(i,j) & hb(j,i) or
        # hb(i-1,j+1) & hb(j-1,i+1); parallel: hb(i-1,j) & hb(j,i+1) or
        # hb(j-1,i) & hb(i,j+1). Each term is a shifted view [i-1, j-1].
        hbp = np.zeros((R + 2, R + 2), bool)
        hbp[1 : R + 1, 1 : R + 1] = hb
        x_ij = hbp[1 : R + 1, 1 : R + 1]          # hb(i, j)
        x_im1_jp1 = hbp[0:R, 2 : R + 2]           # hb(i-1, j+1)
        x_im1_j = hbp[0:R, 1 : R + 1]             # hb(i-1, j)
        x_i_jp1 = hbp[1 : R + 1, 2 : R + 2]       # hb(i, j+1)
        bridge = (
            (x_ij & x_ij.T) | (x_im1_jp1 & x_im1_jp1.T)
            | (x_im1_j & x_i_jp1.T) | (x_im1_j.T & x_i_jp1)
        )
        bridge = np.triu(bridge, k=3)
        is_e = bridge.any(axis=1) | bridge.any(axis=0)

        # n-turns: hb(i+n, i) is an n-turn at i; two consecutive turns ->
        # helix from i+1 to i+n.
        helix = np.zeros(R, bool)
        for n in (4, 3, 5):  # H > G > I priority
            if R - n <= 1:
                continue
            turn = np.zeros(R, bool)
            turn[: R - n] = hb[np.arange(n, R), np.arange(R - n)]
            starts = np.where(turn[1 : R - n] & turn[: R - n - 1])[0] + 1
            for k in range(1, n + 1):
                helix[starts + k] = True
        ss[helix] = "H"

        ss[(is_e) & (ss == "C")] = "E"
    return out


def dssp_match_accuracy(
    ref: BackboneTraj, sample: BackboneTraj, pairs: list[tuple[int, int]]
) -> np.ndarray:
    """Fraction of matched residues with equal 3-class SS per frame
    (metrics.py:70-106)."""
    ri = _indices_for(ref, [p[0] for p in pairs])
    si = _indices_for(sample, [p[1] for p in pairs])
    d_ref = dssp_simplified(ref)[:, ri]
    d_sam = dssp_simplified(sample)[:, si]
    if d_ref.shape[0] == 1 and d_sam.shape[0] > 1:
        d_ref = np.repeat(d_ref, d_sam.shape[0], axis=0)
    return np.mean(d_ref == d_sam, axis=1)


# ------------------------------------------------------------------ #
# LDDT                                                                 #
# ------------------------------------------------------------------ #


def lddt(
    ref: BackboneTraj,
    sample: BackboneTraj,
    pairs: list[tuple[int, int]],
    inclusion_radius: float = 15.0,
    thresholds: tuple[float, ...] = (0.5, 1.0, 2.0, 4.0),
) -> np.ndarray:
    """Backbone LDDT per frame (Mariani et al. 2013; metrics.py:109-187):
    all inter-residue backbone atom pairs of the matched residues whose
    reference distance is within the inclusion radius."""
    ri = _indices_for(ref, [p[0] for p in pairs])
    si = _indices_for(sample, [p[1] for p in pairs])
    n_res = len(ri)
    ref_atoms = ref.coords[0, ri].reshape(-1, 3)  # [n_res*4, 3]
    sam_atoms = sample.coords[:, si].reshape(sample.n_frames, -1, 3)

    # Pairs of atoms not in the same residue.
    atom_res = np.repeat(np.arange(n_res), 4)
    ii, jj = np.triu_indices(n_res * 4, k=1)
    keep = atom_res[ii] != atom_res[jj]
    ii, jj = ii[keep], jj[keep]

    d_ref = np.linalg.norm(ref_atoms[ii] - ref_atoms[jj], axis=-1)
    within = d_ref <= inclusion_radius
    ii, jj, d_ref = ii[within], jj[within], d_ref[within]

    d_sam = np.linalg.norm(sam_atoms[:, ii] - sam_atoms[:, jj], axis=-1)  # [F, P]
    diff = np.abs(d_sam - d_ref[None])
    th = np.asarray(thresholds)
    return (diff[None] < th[:, None, None]).mean(axis=-1).mean(axis=0)


# ------------------------------------------------------------------ #
# Contacts                                                             #
# ------------------------------------------------------------------ #


def _contact_maps(
    ref: BackboneTraj,
    sample: BackboneTraj,
    pairs: list[tuple[int, int]],
    reference_resid_pairs: list[tuple[int, int]] | None = None,
    threshold: float = 8.0,
    exclude_n_neighbours: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CA contact maps over matched residue combinations
    (metrics.py:190-280). Returns (contacts_ref [1|F, P], contacts_sample
    [F, P], resid_pairs [P, 2] in ref resSeq)."""
    resids_i = np.asarray([p[0] for p in pairs], int)
    resids_j = np.asarray([p[1] for p in pairs], int)
    # combinations(resids_i, 2), in its order.
    a, b = np.triu_indices(len(pairs), k=1)
    keep = np.abs(resids_i[a] - resids_i[b]) >= exclude_n_neighbours
    a, b = a[keep], b[keep]
    if reference_resid_pairs is not None:
        allowed = np.asarray(list(reference_resid_pairs), int).reshape(-1, 2)
        span = int(max(resids_i.max(initial=0), allowed.max(initial=0))) + 1
        allowed_keys = np.concatenate([allowed[:, 0] * span + allowed[:, 1],
                                       allowed[:, 1] * span + allowed[:, 0]])
        keep = np.isin(resids_i[a] * span + resids_i[b], allowed_keys)
        a, b = a[keep], b[keep]
    combs_arr = np.stack([resids_i[a], resids_i[b]], axis=-1)

    ref_map = ref.resseq_to_index()
    sam_map = sample.resseq_to_index()
    ref_of = np.asarray([ref_map[int(r)] for r in resids_i], int)
    sam_of = np.asarray([sam_map[int(r)] for r in resids_j], int)
    ref_idx = np.stack([ref_of[a], ref_of[b]], axis=-1)
    sam_idx = np.stack([sam_of[a], sam_of[b]], axis=-1)

    ref_ca = ref.coords[:, :, CA_IN_BACKBONE]
    sam_ca = sample.coords[:, :, CA_IN_BACKBONE]
    d_ref = np.linalg.norm(
        ref_ca[:, ref_idx[:, 0]] - ref_ca[:, ref_idx[:, 1]], axis=-1
    )
    d_sam = np.linalg.norm(
        sam_ca[:, sam_idx[:, 0]] - sam_ca[:, sam_idx[:, 1]], axis=-1
    )
    return (d_ref < threshold).astype(int), (d_sam < threshold).astype(int), combs_arr


def fraction_native_contacts(
    ref: BackboneTraj,
    sample: BackboneTraj,
    pairs: list[tuple[int, int]],
    reference_resid_pairs: list[tuple[int, int]] | None = None,
    threshold: float = 8.0,
    exclude_n_neighbours: int = 0,
) -> np.ndarray:
    """Fraction of the reference's positive contacts matched per frame
    (metrics.py:283-317)."""
    c_ref, c_sam, _ = _contact_maps(
        ref, sample, pairs, reference_resid_pairs, threshold, exclude_n_neighbours
    )
    native = np.where(c_ref[0] == 1)[0]
    return np.mean(c_ref[:, native] == c_sam[:, native], axis=1)


def contact_distances(
    ref: BackboneTraj,
    sample: BackboneTraj,
    pairs: list[tuple[int, int]],
    threshold: float = 8.0,
) -> np.ndarray:
    """Per-residue-averaged mismatched-contact counts (metrics.py:320-356)."""
    c_ref, c_sam, combs = _contact_maps(ref, sample, pairs, threshold=threshold)
    unmatched = np.abs(c_ref - c_sam).astype(np.float64)  # [F, P]
    resids, slots = np.unique(combs, return_inverse=True)
    slots = slots.reshape(combs.shape)
    # Each residue's count of mismatched contacts, frame by frame.
    per_res = np.empty((len(resids), unmatched.shape[0]))
    for f in range(unmatched.shape[0]):
        per_res[:, f] = (np.bincount(slots[:, 0], unmatched[f], len(resids))
                         + np.bincount(slots[:, 1], unmatched[f], len(resids)))
    return per_res.mean(axis=0)
