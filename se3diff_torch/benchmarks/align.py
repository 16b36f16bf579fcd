"""Sequence alignment + structural superposition for the benchmark suite.

From-scratch replacements for the reference's external dependencies
(`bioemu-benchmarks/bioemu_benchmarks/eval/multiconf/align.py`): Biopython
``pairwise2.align.globalxx`` becomes a Needleman–Wunsch implementation with
the same scoring (match=1, mismatch=0, no gap penalty), mdtraj superposition
becomes a numpy Kabsch, and the USalign binary's TM-score becomes a native
iterative TM-score (with an optional USalign subprocess adapter in
``metrics.tm_score_usalign`` when the binary is available).

Copy of ``se3diff_tpu/benchmarks/align.py``: the numpy implementations are
the oracle, ``native/libtmscore.so`` (built from ``native/tmscore.cpp``) the
batch core.
"""

from __future__ import annotations

import numpy as np


def nw_align(seq_a: str, seq_b: str) -> tuple[str, str]:
    """Global Needleman–Wunsch with match=1, mismatch=0, gap=0 (globalxx).

    Returns one optimal alignment pair (gaps as '-'). Tie-breaking follows
    up > left > diagonal during traceback (rightmost matches), which
    reproduces Biopython pairwise2's first globalxx alignment on the
    benchmark's sequence pairs (verified: E1C7U0's recorded local 1-recall
    moves from 6.505 under leftmost matching to 6.028 vs the reference's
    6.033).
    """
    n, m = len(seq_a), len(seq_b)
    a = np.frombuffer(seq_a.encode(), np.uint8)
    b = np.frombuffer(seq_b.encode(), np.uint8)
    score = np.zeros((n + 1, m + 1), np.int32)
    match = (a[:, None] == b[None, :]).astype(np.int32)
    for i in range(1, n + 1):
        diag = score[i - 1, :-1] + match[i - 1]
        up = score[i - 1, 1:]
        # left depends on running max within the row; compute sequentially.
        row = score[i]
        best = np.maximum(diag, up)
        prev = 0
        for j in range(1, m + 1):
            v = best[j - 1]
            if prev > v:
                v = prev
            row[j] = v
            prev = v
    # Traceback (gaps preferred over matches on ties -> rightmost register).
    out_a, out_b = [], []
    i, j = n, m
    while i > 0 and j > 0:
        s = score[i, j]
        if s == score[i - 1, j]:
            out_a.append(seq_a[i - 1])
            out_b.append("-")
            i -= 1
        elif s == score[i, j - 1]:
            out_a.append("-")
            out_b.append(seq_b[j - 1])
            j -= 1
        else:
            out_a.append(seq_a[i - 1])
            out_b.append(seq_b[j - 1])
            i -= 1
            j -= 1
    while i > 0:
        out_a.append(seq_a[i - 1])
        out_b.append("-")
        i -= 1
    while j > 0:
        out_a.append("-")
        out_b.append(seq_b[j - 1])
        j -= 1
    return "".join(reversed(out_a)), "".join(reversed(out_b))


def matching_positions(seq_a: str, seq_b: str) -> list[tuple[int, int]]:
    """0-based index pairs of aligned (non-gap in both) positions."""
    aln_a, aln_b = nw_align(seq_a, seq_b)
    pairs = []
    ia = ib = 0
    for ca, cb in zip(aln_a, aln_b):
        if ca != "-" and cb != "-":
            pairs.append((ia, ib))
        ia += ca != "-"
        ib += cb != "-"
    return pairs


def kabsch_rotation(P: np.ndarray, Q: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Optimal rotation R (det +1) + centroids aligning P onto Q.

    ``R @ (p - cP) + cQ`` minimizes RMSD. P, Q: [N, 3].
    """
    cP = P.mean(axis=0)
    cQ = Q.mean(axis=0)
    H = (P - cP).T @ (Q - cQ)
    U, _, Vt = np.linalg.svd(H.astype(np.float64))
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    return R, cP, cQ


def superpose(mobile: np.ndarray, target: np.ndarray, fit_idx=None) -> np.ndarray:
    """Superpose ``mobile [.., N, 3]`` frames onto ``target [N, 3]`` using the
    atoms in ``fit_idx`` (default: all); the transform is applied to all
    atoms (mdtraj ``Trajectory.superpose`` semantics)."""
    mobile = np.asarray(mobile, np.float64)
    single = mobile.ndim == 2
    if single:
        mobile = mobile[None]
    if fit_idx is None:
        fit_idx = np.arange(target.shape[0])
    out = np.empty_like(mobile)
    for f in range(mobile.shape[0]):
        R, cP, cQ = kabsch_rotation(mobile[f][fit_idx], target[fit_idx])
        out[f] = (mobile[f] - cP) @ R.T + cQ
    return out[0] if single else out


def rmsd_optimal(mobile: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Minimum (optimally superposed) RMSD per frame.

    ``mobile [F, N, 3]`` vs ``target [N, 3]`` -> ``[F]`` in input units.
    Equivalent to mdtraj's QCP ``rmsd`` (evaluate.py:236-249) up to fp error.
    """
    mobile = np.asarray(mobile, np.float64)
    single = mobile.ndim == 2
    if single:
        mobile = mobile[None]
    target = np.asarray(target, np.float64)
    cT = target.mean(axis=0)
    T0 = target - cT
    gT = (T0**2).sum()
    out = np.empty(mobile.shape[0])
    N = target.shape[0]
    for f in range(mobile.shape[0]):
        M0 = mobile[f] - mobile[f].mean(axis=0)
        H = M0.T @ T0
        sv = np.linalg.svd(H, compute_uv=False)
        # Proper-rotation correction: flip the smallest singular value if
        # det < 0 (Kabsch).
        det = np.linalg.det(H)
        if det < 0:
            sv[-1] = -sv[-1]
        e = (M0**2).sum() + gT - 2.0 * sv.sum()
        out[f] = np.sqrt(max(e, 0.0) / N)
    return out


def tm_d0(l_target: int) -> float:
    """TM-score normalization distance (Zhang & Skolnick 2004)."""
    if l_target > 15:
        return 1.24 * np.cbrt(l_target - 15) - 1.8
    return 0.5


def tm_score_fixed_pairing(
    mobile_ca: np.ndarray, target_ca: np.ndarray, max_iter: int = 20
) -> float:
    """TM-score with a fixed residue pairing via the TM-score program's
    iterative superposition heuristic.

    Seeds superpositions from multiple contiguous fragments (full chain,
    halves, quarters, eighths), then alternates (superpose on included set ->
    include residues with d < d0_search) until the included set converges;
    reports the best TM over all seeds. This reproduces the fixed-alignment
    stage of USalign/TM-score (the reference shells out per frame,
    metrics.py:20-45); normalized by the target length.
    """
    L = target_ca.shape[0]
    n = mobile_ca.shape[0]
    assert n == L, "fixed pairing requires equal-length CA arrays"
    d0 = tm_d0(L)
    d0_search = min(max(d0, 4.5), 8.0)

    def tm_of(coords):
        d2 = ((coords - target_ca) ** 2).sum(-1)
        return float(np.mean(1.0 / (1.0 + d2 / d0**2)))

    best = 0.0
    seeds = []
    for frag in (L, L // 2, L // 4, max(L // 8, 4)):
        if frag < 4:
            continue
        step = max(frag // 2, 1)
        for start in range(0, L - frag + 1, step):
            seeds.append(np.arange(start, start + frag))
    for seed in seeds:
        idx = seed
        prev: set[int] = set()
        for _ in range(max_iter):
            if len(idx) < 3:
                break
            R, cP, cQ = kabsch_rotation(mobile_ca[idx], target_ca[idx])
            moved = (mobile_ca - cP) @ R.T + cQ
            best = max(best, tm_of(moved))
            d = np.sqrt(((moved - target_ca) ** 2).sum(-1))
            cut = d0_search
            new_idx = np.where(d < cut)[0]
            while len(new_idx) < 3 and cut < 8.0:
                cut += 0.5
                new_idx = np.where(d < cut)[0]
            if set(new_idx) == prev:
                break
            prev = set(new_idx)
            idx = new_idx
    return best


# --------------------------------------------------------------------- #
# Native (C++) batch kernels                                             #
# --------------------------------------------------------------------- #
#
# The evaluator scores hundreds of thousands of frame/reference pairs;
# `native/tmscore.cpp` implements the SAME two algorithms as above (Kabsch
# via a 3x3 Jacobi eigen-solver + the fragment-seeded TM-score iteration)
# behind a C ABI, ~30-50x faster per frame. The numpy implementations above
# remain the oracle (tests/test_native_tmscore.py) and the fallback when the
# toolchain is unavailable.

_NATIVE_DIR = __import__("pathlib").Path(__file__).resolve().parents[2] / "native"
_tmlib = None
_tmlib_failed = False


def _load_tmlib():
    global _tmlib, _tmlib_failed
    if _tmlib is not None or _tmlib_failed:
        return _tmlib
    import ctypes
    import subprocess

    lib_path = _NATIVE_DIR / "libtmscore.so"
    try:
        if not lib_path.exists():
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), "libtmscore.so"],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(lib_path))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.tm_score_batch.restype = ctypes.c_int
        lib.tm_score_batch.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, dp]
        lib.rmsd_batch.restype = ctypes.c_int
        lib.rmsd_batch.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int, dp]
        _tmlib = lib
    except Exception:
        _tmlib_failed = True
    return _tmlib


def _as_frames(mobile: np.ndarray) -> tuple[np.ndarray, bool]:
    mobile = np.ascontiguousarray(mobile, np.float64)
    if mobile.ndim == 2:
        return mobile[None], True
    return mobile, False


def tm_score_fixed_pairing_batch(
    mobile_ca: np.ndarray, target_ca: np.ndarray, max_iter: int = 20
) -> np.ndarray:
    """``tm_score_fixed_pairing`` over ``[F, L, 3]`` frames; native C++ core
    when available, per-frame numpy otherwise."""
    import ctypes

    frames, single = _as_frames(mobile_ca)
    target = np.ascontiguousarray(target_ca, np.float64)
    lib = _load_tmlib()
    if lib is not None:
        F, L = frames.shape[:2]
        out = np.empty(F, np.float64)
        dp = ctypes.POINTER(ctypes.c_double)
        rc = lib.tm_score_batch(
            frames.ctypes.data_as(dp), target.ctypes.data_as(dp),
            F, L, max_iter, out.ctypes.data_as(dp),
        )
        if rc == 0:
            return out[0] if single else out
    out = np.array(
        [tm_score_fixed_pairing(f, target, max_iter=max_iter) for f in frames]
    )
    return out[0] if single else out


def rmsd_optimal_native(mobile: np.ndarray, target: np.ndarray) -> np.ndarray:
    """``rmsd_optimal`` through the native core (numpy fallback)."""
    import ctypes

    frames, single = _as_frames(mobile)
    target = np.ascontiguousarray(target, np.float64)
    lib = _load_tmlib()
    if lib is not None:
        F, L = frames.shape[:2]
        out = np.empty(F, np.float64)
        dp = ctypes.POINTER(ctypes.c_double)
        rc = lib.rmsd_batch(
            frames.ctypes.data_as(dp), target.ctypes.data_as(dp),
            F, L, out.ctypes.data_as(dp),
        )
        if rc == 0:
            return out[0] if single else out
    return rmsd_optimal(mobile, target)
