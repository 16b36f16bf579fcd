"""Fused IPA attention core: the CUDA kernel for Hopper, its plain version,
and its row-chunked backward.

Counterpart of ``se3diff_tpu/ops/pallas_ipa.py::fused_ipa_attention_diff``,
whose forward is the Pallas body ``_kernel``, in both of its variants: the
pair bias ``pa`` streamed (``has_pa=True``), or computed inside the kernel
as ``pa = x2d @ w_pb`` (``has_pa=False``). For query rows i, key columns j
and heads h:

    s[h,i,j] = scalar_w <q_s, k_s> - sum_{p<4} |q_p - k_p| + pair_w pa + bias[j]
    a        = softmax_j(s)                         (f32)
    out_s    = sum_j a v_s                          [B, H, Lq, dk]  model dtype
    out_p    = sum_j a v_p                          [B, H, Lq, 24]  f32
    out_pair = (sum_j a x2d[i, j, :]) @ w_pv[h]     [B, H, Lq, dk]  model dtype

Operands keep the JAX kernel's layout: q/k/v_s ``[B, H, L, dk]`` (model
dtype), point planes ``[B, 3, H*4, L]`` f32 pre-scaled by half the per-head
point weight, ``v_p [B, H, Lk, 24]`` f32, ``x2d [B, Lq, Lk, Cp]`` and
``pa [B, H, Lq, Lk]`` (model dtype), ``w_pv [H, Cp, dk]`` (model dtype) and a
column ``bias [B, Lk]`` f32 holding :data:`NEG_INF` at masked columns. In
place of ``pa`` a caller may give ``w_pb [Cp, H]`` f32: ``pa = x2d @ w_pb``
is then computed with ``w_pb`` rounded to ``x2d``'s dtype and f32 sums, and
never rounded itself (``pallas_ipa.py:399-406``).

:func:`ipa_attention` is differentiable. Its forward dispatches on the
device of its operands alone: CPU tensors go through
:func:`ipa_attention_plain`, which takes any width; CUDA tensors launch a
kernel or raise. The card takes the widths in :data:`CARD_WIDTHS` (4, 8,
16 or 32 heads of width 16, ``Cp <= 256``, ``Cp % 4 == 0``);
:func:`check_card_widths` holds a model config against them before a model
is bound to the card. Ten kernel designs, all built with ``nvcc`` for
``sm_90a`` at first use into one library bound through ``ctypes``, and a
static rule on the widths (:func:`kernel_route`) picks one:

- ``"tc"`` (``csrc/ipa_attention_tc.cu``): bf16, 32 heads, the streamed
  pair bias and ``Cp % 32 == 0``, the score model's bf16 launches: x2d and
  pa tiles staged by ``cp.async``, the x2d aggregate on tensor cores;
- ``"tc_f32"`` (``csrc/ipa_attention_tc_f32.cu``): the same widths in f32,
  the score model's launches at every CLI's default dtype: f32 tiles staged
  by ``cp.async``, the x2d aggregate on 3xTF32 ``mma.sync`` (f32 accuracy);
- ``"tc_pb"`` and ``"tc_pb_f32"`` (the in-kernel variants of the same two
  sources): the in-kernel pair bias at 32 heads and ``Cp % 32 == 0``, bf16
  and f32: ``pa = x2d @ w_pb`` formed on ``mma.sync`` from the staged x2d
  tile (bf16 operands, or 3xTF32), never read from device memory;
- ``"tc16"`` (``csrc/ipa_attention_tc16.cu``) and ``"tc16_f32"``
  (``csrc/ipa_attention_tc16_f32.cu``): the same widths at 16 heads, bf16
  and f32, the launches of every tensor-parallel rank at ``--mesh
  model=2``: one m16 tile of ``mma.sync`` a query row's heads, two
  256-thread blocks an SM;
- ``"tc8"`` (``csrc/ipa_attention_tc8.cu``) and ``"tc8_f32"``
  (``csrc/ipa_attention_tc8_f32.cu``): the same widths at 8 heads, bf16
  and f32, the launches of every tensor-parallel rank at ``--mesh
  model=4``: the x2d product transposed (channels as M, the 8 heads as
  N), a warp a query row of a block's 8, one x2d stage, two 256-thread
  blocks an SM;
- ``"h4"`` (``csrc/ipa_attention_h4.cu``): f32, 4 heads, the in-kernel pair
  bias and ``Cp <= H4_MAX_CP``, every attention of the PPFT control net: a
  warp a query row with its 4 heads, x2d tiles staged once by ``cp.async``
  and read twice from shared memory, on CUDA-core FMAs;
- ``"simt"`` (``csrc/ipa_attention.cu``): every other card width (bf16 at 4
  heads, the streamed variant at 4 heads, the in-kernel pair bias at 8 and
  16 heads, ``Cp % 32 != 0``), on CUDA-core FMAs.

Nothing falls back at run time. The backward (the JAX package's is XLA
code, ``_fused_backward_chunked``, not a Pallas kernel) dispatches by device
and by a static rule on the widths (:func:`backward_route`): CPU tensors,
and every CUDA width but those below, run :func:`ipa_attention_backward`
(PyTorch, row-chunked; route ``"torch"``); CUDA tensors of these widths
launch a kernel or raise:

- ``"bwd_tc"`` / ``"bwd_tc_f32"`` (``csrc/ipa_attention_bwd_tc.cu``): 32
  heads, the streamed pair bias and ``Cp % 32 == 0``, bf16 / f32: the score
  model's backward on every training path. Its algebra (a statistics sweep,
  D from row aggregates, column sums from saved row statistics, the
  tensor-core operands' roundings) is :func:`ipa_attention_backward_tiled`;
- ``"bwd_tc16"`` / ``"bwd_tc16_f32"`` (``csrc/ipa_attention_bwd_tc16.cu``):
  the same at 16 heads, a tensor-parallel rank's backward at ``--mesh
  model=2``: the same algebra at one m16 tile a row's heads, two 256-thread
  blocks an SM;
- ``"bwd_tc8"`` / ``"bwd_tc8_f32"`` (``csrc/ipa_attention_bwd_tc8.cu``): the
  same at 8 heads, a tensor-parallel rank's backward at ``--mesh model=4``:
  the same algebra with the x2d contractions shaped to the 8 heads (N of
  the aggregate and of G, K of d_x2d), one pass over x2d, two 256-thread
  blocks an SM;
- ``"bwd_h4"`` (``csrc/ipa_attention_bwd_h4.cu``): f32, 4 heads, the
  in-kernel pair bias and ``Cp <= H4_MAX_CP``: the PPFT control net's
  backward. Its algebra (one sweep over x2d carrying the statistics, D and
  the x2d aggregates online; d_w_pb from them; a second sweep without x2d)
  is :func:`ipa_attention_backward_h4_tiled`.

No path calls the two ``*_tiled`` functions.

:func:`sp_ipa_attention` is the sequence-parallel form: one rank's slab of
query rows against every column, the same kernel launched on the slab.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "NEG_INF",
    "ipa_attention",
    "ipa_attention_backward",
    "ipa_attention_backward_tiled",
    "ipa_attention_backward_h4_tiled",
    "ipa_attention_plain",
    "sp_ipa_attention",
    "build_library",
    "library_path",
    "CARD_WIDTHS",
    "H4_MAX_CP",
    "check_card_widths",
    "kernel_route",
    "backward_route",
]

# Finite mask value for column biases: the online softmax never meets inf-inf.
NEG_INF = -1e30

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Attention widths the card's kernels take; the plain version (any CPU
# tensor) takes every width, as the JAX package does.
CARD_WIDTHS = {"heads": (4, 8, 16, 32), "head_dim": 16, "max_cp": 256, "cp_multiple": 4}
# The largest pair width of the "h4" design (its shared memory's limit:
# ``kMaxCp`` of csrc/ipa_attention_h4.cu); wider 4-head f32 shapes take "simt".
H4_MAX_CP = 64
# The kernel design each route launches, by C symbol.
_ROUTE_SYMBOLS = {"tc": "ipa_attention_tc_fwd", "tc_f32": "ipa_attention_tc_f32_fwd",
                  "tc_pb": "ipa_attention_tc_pb_fwd", "tc_pb_f32": "ipa_attention_tc_pb_f32_fwd",
                  "tc16": "ipa_attention_tc16_fwd", "tc16_f32": "ipa_attention_tc16_f32_fwd",
                  "tc8": "ipa_attention_tc8_fwd", "tc8_f32": "ipa_attention_tc8_f32_fwd",
                  "h4": "ipa_attention_h4_fwd", "simt": "ipa_attention_fwd"}
# The tensor-core designs of the streamed pair bias, by head count and dtype.
_TC_ROUTES = {(32, torch.bfloat16): "tc", (32, torch.float32): "tc_f32",
              (16, torch.bfloat16): "tc16", (16, torch.float32): "tc16_f32",
              (8, torch.bfloat16): "tc8", (8, torch.float32): "tc8_f32"}
# The tensor-core designs of the in-kernel pair bias, by head count and dtype.
_PB_ROUTES = {(32, torch.bfloat16): "tc_pb", (32, torch.float32): "tc_pb_f32"}

# The backward design each backward route launches, by C symbol; "torch"
# (ipa_attention_backward) launches none.
_BWD_ROUTE_SYMBOLS = {"bwd_tc": "ipa_attention_bwd_tc", "bwd_tc_f32": "ipa_attention_bwd_tc_f32",
                      "bwd_tc16": "ipa_attention_bwd_tc16",
                      "bwd_tc16_f32": "ipa_attention_bwd_tc16_f32",
                      "bwd_tc8": "ipa_attention_bwd_tc8",
                      "bwd_tc8_f32": "ipa_attention_bwd_tc8_f32",
                      "bwd_h4": "ipa_attention_bwd_h4"}
# The backward routes whose kernel forms g_wx2d = ct_pr @ w_pv^T itself,
# taking ct_pr and w_pv: every streamed design (the row design of
# csrc/ipa_attention_bwd_rows.cuh at 32 and 16 heads, bwd8_rows at 8).
_BWD_FORMS_G = ("bwd_tc", "bwd_tc_f32", "bwd_tc16", "bwd_tc16_f32", "bwd_tc8", "bwd_tc8_f32")
# The tensor-core backward designs of the streamed pair bias, by head count
# and dtype (Cp % 32 == 0).
_BWD_TC_ROUTES = {(32, torch.bfloat16): "bwd_tc", (32, torch.float32): "bwd_tc_f32",
                  (16, torch.bfloat16): "bwd_tc16", (16, torch.float32): "bwd_tc16_f32",
                  (8, torch.bfloat16): "bwd_tc8", (8, torch.float32): "bwd_tc8_f32"}

# Forward kernel launches made through ipa_attention (plain-version calls and
# backward passes do not count), in all, by variant ("pa" streams the pair
# bias, "w_pb" computes it in the kernel) and by route (see kernel_route).
launches = 0
launches_by_variant = {"pa": 0, "w_pb": 0}
launches_by_route = dict.fromkeys(_ROUTE_SYMBOLS, 0)
# Backward passes of ipa_attention run by autograd, on either device, in all
# and by backward route (see backward_route; "torch" on the CPU too). Direct
# calls of ipa_attention_backward and the uncounted launches of
# _launch_backward do not count.
backward_calls = 0
backward_calls_by_route = dict.fromkeys((*_BWD_ROUTE_SYMBOLS, "torch"), 0)

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def _widths_error(H: int, dk: int, cp: int) -> str | None:
    w = CARD_WIDTHS
    if H in w["heads"] and dk == w["head_dim"] and 0 < cp <= w["max_cp"] and cp % w["cp_multiple"] == 0:
        return None
    return (f"the card's IPA attention kernels take {', '.join(map(str, w['heads']))} heads of "
            f"width {w['head_dim']} and a pair width Cp <= {w['max_cp']} with Cp % "
            f"{w['cp_multiple']} == 0; got {H} heads of width {dk}, Cp={cp} (the CPU takes any "
            "width)")


def check_card_widths(model_cfg, device) -> None:
    """Raise ``ValueError``, naming the supported widths, when ``device`` is
    a CUDA device and the card's kernels do not take the attention widths of
    the DiG model config ``model_cfg`` (``num_heads``, ``dim_model /
    num_heads``, ``dim_pair``; missing keys take the model's defaults).
    Other devices take any width. Reads no device state, so callers run it
    before resolving the device."""
    if torch.device(device).type != "cuda":
        return
    heads = int(model_cfg.get("num_heads", 32))
    dim_model, cp = int(model_cfg.get("dim_model", 512)), int(model_cfg.get("dim_pair", 256))
    err = _widths_error(heads, dim_model // heads if dim_model % heads == 0 else -1, cp)
    if err is not None:
        raise ValueError(f"model config (dim_model={dim_model}, num_heads={heads}, "
                         f"dim_pair={cp}): {err}")


def kernel_route(dtype: torch.dtype, H: int, dk: int, cp: int, has_pa: bool) -> str:
    """The kernel design that CUDA operands of these widths launch: for 32
    heads, the streamed pair bias and ``Cp % 32 == 0``, ``"tc"`` in bf16 and
    ``"tc_f32"`` in f32, at 16 heads ``"tc16"`` and ``"tc16_f32"`` (a
    tensor-parallel rank at ``--mesh model=2``), and at 8 heads ``"tc8"``
    and ``"tc8_f32"`` (a rank at ``--mesh model=4``); for 32 heads, the
    in-kernel pair bias and ``Cp % 32 == 0``, ``"tc_pb"`` in bf16 and
    ``"tc_pb_f32"`` in f32; ``"h4"`` for f32 at 4 heads with the in-kernel
    pair bias and ``Cp <= H4_MAX_CP``; ``"simt"`` for every other width in
    :data:`CARD_WIDTHS`. Raises ``ValueError`` for widths none takes."""
    err = _widths_error(H, dk, cp)
    if err is not None:
        raise ValueError(err)
    routes = _TC_ROUTES if has_pa else _PB_ROUTES
    if cp % 32 == 0 and (H, dtype) in routes:
        return routes[H, dtype]
    if H == 4 and not has_pa and dtype == torch.float32 and cp <= H4_MAX_CP:
        return "h4"
    return "simt"


def backward_route(dtype: torch.dtype, H: int, dk: int, cp: int, has_pa: bool) -> str:
    """The backward that CUDA operands of these widths run: for 32 heads,
    the streamed pair bias and ``Cp % 32 == 0``, the kernel
    ``csrc/ipa_attention_bwd_tc.cu``, ``"bwd_tc"`` in bf16 and
    ``"bwd_tc_f32"`` in f32; the same at 16 heads (a tensor-parallel rank
    at ``--mesh model=2``), the kernel ``csrc/ipa_attention_bwd_tc16.cu``,
    ``"bwd_tc16"`` and ``"bwd_tc16_f32"``, and at 8 heads (a rank at
    ``--mesh model=4``), the kernel ``csrc/ipa_attention_bwd_tc8.cu``,
    ``"bwd_tc8"`` and ``"bwd_tc8_f32"``; for f32 at 4 heads with the
    in-kernel pair bias and ``Cp <= H4_MAX_CP`` (the PPFT control net), the
    kernel ``csrc/ipa_attention_bwd_h4.cu``, ``"bwd_h4"``; ``"torch"``
    (:func:`ipa_attention_backward`) for every other width in
    :data:`CARD_WIDTHS`. CPU operands always run ``"torch"``. Raises
    ``ValueError`` for widths the card refuses."""
    err = _widths_error(H, dk, cp)
    if err is not None:
        raise ValueError(err)
    if has_pa and cp % 32 == 0 and (H, dtype) in _BWD_TC_ROUTES:
        return _BWD_TC_ROUTES[H, dtype]
    if not has_pa and H == 4 and dtype == torch.float32 and cp <= H4_MAX_CP:
        return "bwd_h4"
    return "torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the IPA attention kernel cannot be built")


def library_path() -> Path:
    """Where :func:`build_library` puts the library: named by a digest of
    the flags, every ``csrc/*.cu`` and every header beside them
    (``*.cuh``, ``*.h``), so an edit to any of them builds anew."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libipa_attention_{digest.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, str]:
    """Compile every ``csrc/*.cu`` into one library at :func:`library_path`
    unless it is already there: one ``nvcc`` a source, all started together,
    then one link. Returns ``(path, compiler log)``; the log holds ptxas's
    register, shared-memory and spill report after a fresh build."""
    sources = sorted(CSRC.glob("*.cu"))
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for src, p, text in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) building {src}:\n{text}")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) linking {out.name}:\n"
                               f"{res.stdout}{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, "".join(logs)


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for name in _ROUTE_SYMBOLS.values():
                fn = getattr(lib, name)
                fn.argtypes = [vp] * 14 + [ci] * 8 + [cf, cf, vp]
                fn.restype = ci
            # Backward: the streamed designs' 13 operands (ct_pr and w_pv
            # last), 13 outputs and scratch; or bwd_h4's 13 operands (w_pb
            # in, no pa), 9 outputs (d_w_pv and d_w_pb, no d_pa) and 3
            # scratch; 6 sizes, 2 weights, the stream.
            for route, name in _BWD_ROUTE_SYMBOLS.items():
                fn = getattr(lib, name)
                fn.argtypes = [vp] * (26 if route in _BWD_FORMS_G else 25) + [ci] * 6 + [cf, cf, vp]
                fn.restype = ci
            lib.ipa_attention_bwd_h4_row_blocks.argtypes = [ci, ci, ci]
            lib.ipa_attention_bwd_h4_row_blocks.restype = ci
            lib.ipa_attention_bwd_cols_smem_bytes.argtypes = []
            lib.ipa_attention_bwd_cols_smem_bytes.restype = ci
            lib.ipa_attention_error_string.argtypes = [ci]
            lib.ipa_attention_error_string.restype = ctypes.c_char_p
            lib.ipa_attention_takes_heads.argtypes = [ci]
            lib.ipa_attention_takes_heads.restype = ci
            lib.ipa_attention_head_dim.restype = ci
            for name in ("ipa_attention_tc_f32_smem_bytes", "ipa_attention_tc_pb_smem_bytes",
                         "ipa_attention_tc_pb_f32_smem_bytes", "ipa_attention_h4_smem_bytes",
                         "ipa_attention_tc16_smem_bytes", "ipa_attention_tc16_f32_smem_bytes",
                         "ipa_attention_tc16_blocks_per_sm",
                         "ipa_attention_tc8_smem_bytes", "ipa_attention_tc8_f32_smem_bytes",
                         "ipa_attention_tc8_blocks_per_sm", "ipa_attention_tc8_f32_blocks_per_sm",
                         "ipa_attention_bwd_tc_smem_bytes", "ipa_attention_bwd_tc_f32_smem_bytes",
                         "ipa_attention_bwd_tc_blocks_per_sm",
                         "ipa_attention_bwd_tc_f32_blocks_per_sm",
                         "ipa_attention_bwd_h4_smem_bytes", "ipa_attention_bwd_h4_blocks_per_sm",
                         "ipa_attention_bwd_tc16_smem_bytes",
                         "ipa_attention_bwd_tc16_f32_smem_bytes",
                         "ipa_attention_bwd_tc16_blocks_per_sm",
                         "ipa_attention_bwd_tc16_f32_blocks_per_sm",
                         "ipa_attention_bwd_tc8_smem_bytes",
                         "ipa_attention_bwd_tc8_f32_smem_bytes",
                         "ipa_attention_bwd_tc8_blocks_per_sm",
                         "ipa_attention_bwd_tc8_f32_blocks_per_sm",
                         "ipa_attention_tc16_f32_blocks_per_sm"):
                getattr(lib, name).argtypes = [ci]
                getattr(lib, name).restype = ci
            for name in ("ipa_attention_bwd_tc8_cols_blocks_per_sm",
                         "ipa_attention_bwd_tc8_f32_cols_blocks_per_sm"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ci
            _lib = lib
        return _lib


def _pair_bias(x2d, w_pb):
    """``x2d @ w_pb`` as ``[B, H, Lq, Lk]`` f32 (f64 for f64 ``x2d``), with
    ``w_pb`` rounded to ``x2d``'s dtype first (pallas_ipa.py:402-405)."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    return torch.einsum("bijp,ph->bhij", x2d.to(acc), w_pb.to(x2d.dtype).to(acc))


def ipa_attention_plain(
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa=None, w_pb=None, *,
    scalar_w: float, pair_w: float,
):
    """Plain PyTorch version, counterpart of ``_fused_semantics_jnp``.

    Model-dtype operands are upcast to f32 before each contraction, which for
    bf16 is exact (bf16 products fit in f32): bf16 operands, f32 sums. The
    softmax weights that multiply ``v_s`` and ``x2d`` are rounded to the
    model dtype first, as in the kernel. With ``pa=None`` the pair bias is
    ``x2d @ w_pb`` in f32. f64 operands are computed in f64: the card's
    gradient checks take autograd through it in f64 as their reference.
    """
    acc = torch.promote_types(q_s.dtype, torch.float32)
    B, H, Lq, _ = q_s.shape
    s = torch.einsum("bhid,bhjd->bhij", q_s.to(acc), k_s.to(acc)) * scalar_w

    qp, kp = q_p.to(acc), k_p.to(acc)
    q2 = (qp * qp).sum(1)                                   # [B, H*4, Lq]
    k2 = (kp * kp).sum(1)                                   # [B, H*4, Lk]
    qk = torch.einsum("bxpi,bxpj->bpij", qp, kp)            # [B, H*4, Lq, Lk]
    d2 = q2[..., :, None] + k2[..., None, :] - 2.0 * qk
    d2 = torch.where(d2 > 0.0, d2, torch.full_like(d2, 1e-24))
    pdist = torch.sqrt(d2).reshape(B, H, 4, Lq, -1).sum(2)  # [B, H, Lq, Lk]
    pair = _pair_bias(x2d, w_pb) if pa is None else pa.to(acc)
    s = s - pdist + pair_w * pair + bias.to(acc)[:, None, None, :]

    a = torch.softmax(s, dim=-1)
    a16 = a.to(v_s.dtype).to(acc)
    out_s = torch.einsum("bhij,bhjd->bhid", a16, v_s.to(acc)).to(q_s.dtype)
    out_p = torch.einsum("bhij,bhjc->bhic", a, v_p.to(acc))
    wx2d = torch.einsum("bhij,bijp->bhip", a16, x2d.to(acc))
    out_pair = torch.einsum("bhip,hpd->bhid", wx2d, w_pv.to(acc)).to(q_s.dtype)
    return out_s, out_p, out_pair


def _check(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb) -> None:
    B, H, Lq, dk = q_s.shape
    Lk = k_s.shape[2]
    Cp = x2d.shape[-1]
    dt = q_s.dtype
    expect = {
        "q_s": (q_s, (B, H, Lq, dk), dt),
        "k_s": (k_s, (B, H, Lk, dk), dt),
        "v_s": (v_s, (B, H, Lk, dk), dt),
        "q_p": (q_p, (B, 3, H * 4, Lq), torch.float32),
        "k_p": (k_p, (B, 3, H * 4, Lk), torch.float32),
        "v_p": (v_p, (B, H, Lk, 24), torch.float32),
        "x2d": (x2d, (B, Lq, Lk, Cp), dt),
        "w_pv": (w_pv, (H, Cp, dk), dt),
        "bias": (bias, (B, Lk), torch.float32),
    }
    if pa is not None:
        expect["pa"] = (pa, (B, H, Lq, Lk), dt)
    else:
        expect["w_pb"] = (w_pb, (Cp, H), torch.float32)
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"model dtype must be float32 or bfloat16, got {dt}")
    for name, (t, shape, dtype) in expect.items():
        if t.device != q_s.device:
            raise ValueError(f"{name} is on {t.device}, q_s on {q_s.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The kernel reads x2d four channels and k_s rows 16 bytes at a time.
    if Cp % 4 or x2d.data_ptr() % 16 or k_s.data_ptr() % 16:
        raise ValueError("the kernel needs Cp % 4 == 0 and 16-byte aligned x2d and k_s")


def _launch_kernel(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb, scalar_w, pair_w,
                   design: str | None = None):
    """Launch a Hopper kernel on the current stream; raise if it cannot.
    ``design`` None launches :func:`kernel_route`'s design and counts the
    launch; a named design is :func:`_launch_design`'s uncounted launch."""
    global launches
    _check(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb)
    B, H, Lq, dk = q_s.shape
    Lk, Cp = k_s.shape[2], x2d.shape[-1]
    route = kernel_route(q_s.dtype, H, dk, Cp, pa is not None)
    if design is not None and design != route and design != "simt":
        raise ValueError(f"the {design!r} design does not take these widths (route {route!r})")
    counted, design = design is None, design or route
    if design in _TC_ROUTES.values() and pa.data_ptr() % 16:
        raise ValueError("the tensor-core designs need a 16-byte aligned pa")
    if design in ("tc_f32", "tc_pb_f32", "tc16_f32", "tc8", "tc8_f32") and w_pv.data_ptr() % 16:
        raise ValueError(f"the {design!r} design needs a 16-byte aligned w_pv")
    if design == "h4" and any(t.data_ptr() % 16 for t in (q_s, v_s, v_p, w_pv, w_pb)):
        raise ValueError("the h4 design needs 16-byte aligned q_s, v_s, v_p, w_pv and w_pb")
    lib = _library()
    if not lib.ipa_attention_takes_heads(H) or dk != lib.ipa_attention_head_dim():
        raise ValueError(_widths_error(H, dk, Cp) or f"the library does not take H={H}, dk={dk}")
    out_s = torch.empty_like(q_s)
    out_p = torch.empty((B, H, Lq, 24), dtype=torch.float32, device=q_s.device)
    out_pair = torch.empty_like(q_s)
    with torch.cuda.device(q_s.device):
        err = getattr(lib, _ROUTE_SYMBOLS[design])(
            q_s.data_ptr(), k_s.data_ptr(), v_s.data_ptr(), q_p.data_ptr(),
            k_p.data_ptr(), v_p.data_ptr(), x2d.data_ptr(), w_pv.data_ptr(),
            bias.data_ptr(), None if pa is None else pa.data_ptr(),
            None if w_pb is None else w_pb.data_ptr(), out_s.data_ptr(), out_p.data_ptr(),
            out_pair.data_ptr(), B, H, Lq, Lk, dk, Cp,
            int(q_s.dtype == torch.bfloat16), int(pa is not None), float(scalar_w), float(pair_w),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ipa_attention kernel launch ({design}) failed: "
            + lib.ipa_attention_error_string(err).decode()
        )
    if counted:
        launches += 1
        launches_by_variant["pa" if pa is not None else "w_pb"] += 1
        launches_by_route[route] += 1
    return out_s, out_p, out_pair


def _launch_design(design: str, q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa=None,
                   w_pb=None, *, scalar_w: float, pair_w: float):
    """Launch the named kernel design on CUDA operands whatever
    :func:`kernel_route` picks (``"simt"`` takes every card width, the other
    designs their own), counting nothing: the yardstick that
    ``chip_smoke.py`` and the card tests time and compare beside the
    route's design. No model path calls it."""
    if design not in _ROUTE_SYMBOLS:
        raise ValueError(f"design must be one of {sorted(_ROUTE_SYMBOLS)}, got {design!r}")
    return _launch_kernel(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb,
                          scalar_w, pair_w, design=design)


def _row_chunks(Lq: int, target: int) -> list[tuple[int, int]]:
    """Row ranges of the backward: ``ceil(Lq / target)`` chunks of near-equal
    size. JAX's ``_row_chunk`` takes the largest divisor of ``Lq`` that is at
    most ``target`` (its scan needs equal chunks), which falls to one row a
    chunk at a prime ``Lq``; a Python loop takes a ragged last chunk instead."""
    n = -(-Lq // target)
    size = -(-Lq // n)
    return [(r0, min(r0 + size, Lq)) for r0 in range(0, Lq, size)]


def ipa_attention_backward(inputs, grad_outputs, *, scalar_w: float, pair_w: float,
                           row_chunk: int = 128):
    """Input gradients of :func:`ipa_attention`, recomputing the attention a
    chunk of query rows at a time.

    Port of ``_fused_backward_chunked`` (``pallas_ipa.py:1036-1181``), both
    variants. No ``[B, H(*4), Lq, Lk]`` tensor larger than one row chunk is
    alive; ``d_x2d`` and ``d_pa``, gradients of L^2 inputs, are L^2
    themselves. With the in-kernel pair bias (``pa`` None) the chunk's bias
    is ``x2d @ w_pb`` in f32 (``w_pb`` not rounded, as in JAX), ``w_pb``
    gets ``sum pair_w ds x2d`` and ``d_x2d`` adds ``pair_w ds @ w_pb^T``. The JAX function's two deliberate choices are kept: the
    attention weights stay f32 where the forward rounds them to the model
    dtype (at most 1 bf16 ulp), and the distance gradient is exactly zero
    wherever ``d2 <= 0``, the clamp's true subgradient (coincident bf16
    points are common; dividing by ``sqrt(1e-24)`` there made bf16 training
    diverge). All arithmetic is f32 (f64 for f64 operands, which the card's
    gradient checks compare against); each gradient is cast to its input's
    dtype at the end.

    ``inputs``: the operands of :func:`ipa_attention` up to ``pa``, and
    optionally ``w_pb`` after it (ten or eleven); ``grad_outputs``:
    ``(d_out_s, d_out_p, d_out_pair)``. Returns one gradient per operand, in
    order, with ``None`` for the column ``bias`` (a constant mask) and for
    whichever of ``pa`` / ``w_pb`` is None.
    """
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, *rest = inputs
    w_pb = rest[0] if rest else None
    ct_s, ct_p, ct_pr = grad_outputs
    acc = torch.promote_types(q_s.dtype, torch.float32)
    B, H, Lq, dk = q_s.shape
    Lk = k_s.shape[2]
    H4 = q_p.shape[2]
    scalar_w, pair_w = float(scalar_w), float(pair_w)

    ks, vs = k_s.to(acc), v_s.to(acc)
    kp, vp = k_p.to(acc), v_p.to(acc)                 # [B, 3, H4, Lk], [B, H, Lk, 24]
    k2 = (kp * kp).sum(1)                             # [B, H4, Lk]
    wpv = w_pv.to(acc)
    bias_row = bias.to(acc)[:, None, None, :]

    d_ks, d_kp = torch.zeros_like(ks), torch.zeros_like(kp)
    d_vs, d_vp = torch.zeros_like(vs), torch.zeros_like(vp)
    d_wpv = torch.zeros_like(wpv)
    d_qs = torch.empty_like(q_s)
    d_qp = torch.empty_like(q_p, dtype=acc)
    d_x2d = torch.empty_like(x2d)
    if pa is not None:
        d_pa, d_wpb = torch.empty_like(pa), None
    else:
        wpb = w_pb.to(acc)
        d_pa, d_wpb = None, torch.zeros_like(wpb)

    for r0, r1 in _row_chunks(Lq, row_chunk):
        R = r1 - r0
        qs_i = q_s[:, :, r0:r1].to(acc)               # [B, H, R, dk]
        qp_i = q_p[..., r0:r1].to(acc)                # [B, 3, H4, R]
        x2f_i = x2d[:, r0:r1].to(acc)                 # [B, R, Lk, Cp]
        ct_s_i = ct_s[:, :, r0:r1].to(acc)
        ct_p_i = ct_p[:, :, r0:r1].to(acc)
        ct_pr_i = ct_pr[:, :, r0:r1].to(acc)

        # Recompute the chunk's attention rows.
        s = torch.einsum("bhid,bhjd->bhij", qs_i, ks) * scalar_w
        q2_i = (qp_i * qp_i).sum(1)                   # [B, H4, R]
        qk = torch.einsum("bxpi,bxpj->bpij", qp_i, kp)
        d2 = (q2_i[..., :, None] + k2[..., None, :] - 2.0 * qk).clamp_min(0.0)
        dist = torch.sqrt(d2 + 1e-24)                 # [B, H4, R, Lk]
        s = s - dist.reshape(B, H, 4, R, Lk).sum(2)
        if pa is not None:
            pa_i = pa[:, :, r0:r1].to(acc)
        else:
            pa_i = torch.einsum("bijp,ph->bhij", x2f_i, wpb)
        s = s + pair_w * pa_i + bias_row
        a = torch.softmax(s, dim=-1)                  # [B, H, R, Lk]

        # Pair-value path: wx2d for d_w_pv; g_wx2d = d(out_pair)/d(wx2d).
        wx2d_i = torch.einsum("bhij,bijp->bhip", a, x2f_i)
        g_wx2d = torch.einsum("bhid,hpd->bhip", ct_pr_i, wpv)
        d_wpv += torch.einsum("bhip,bhid->hpd", wx2d_i, ct_pr_i)

        # Softmax backward over a's three consumers.
        dphat = (
            torch.einsum("bhid,bhjd->bhij", ct_s_i, vs)
            + torch.einsum("bhic,bhjc->bhij", ct_p_i, vp)
            + torch.einsum("bhip,bijp->bhij", g_wx2d, x2f_i)
        )
        ds = a * (dphat - (dphat * a).sum(-1, keepdim=True))

        d_qs[:, :, r0:r1] = scalar_w * torch.einsum("bhij,bhjd->bhid", ds, ks)
        d_ks += scalar_w * torch.einsum("bhij,bhid->bhjd", ds, qs_i)

        # Point distances in matmul form: d dist / d qp = (qp - kp) / dist,
        # summed against w = d_pdist / dist as qp * rowsum(w) - w @ kp, so
        # no [.., R, Lk, 3] difference tensor is made. Zero where d2 <= 0.
        inv_dist = torch.where(d2 > 0.0, 1.0 / dist, torch.zeros_like(dist))
        w = (-ds)[:, :, None] * inv_dist.reshape(B, H, 4, R, Lk)
        w = w.reshape(B, H4, R, Lk)
        d_qp[..., r0:r1] = qp_i * w.sum(-1)[:, None] - torch.einsum("bpij,bxpj->bxpi", w, kp)
        d_kp += kp * w.sum(-2)[:, None] - torch.einsum("bpij,bxpi->bxpj", w, qp_i)

        # Pair-bias branch: the streamed pa gets its own gradient; the
        # in-kernel variant routes through x2d and w_pb instead.
        ds_pw = pair_w * ds
        d_x2d_i = torch.einsum("bhip,bhij->bijp", g_wx2d, a)
        if pa is not None:
            d_pa[:, :, r0:r1] = ds_pw
        else:
            d_wpb += torch.einsum("bhij,bijp->ph", ds_pw, x2f_i)
            d_x2d_i = d_x2d_i + torch.einsum("bhij,ph->bijp", ds_pw, wpb)
        d_x2d[:, r0:r1] = d_x2d_i
        d_vs += torch.einsum("bhij,bhid->bhjd", a, ct_s_i)
        d_vp += torch.einsum("bhij,bhic->bhjc", a, ct_p_i)

    return (
        d_qs, d_ks.to(k_s.dtype), d_vs.to(v_s.dtype),
        d_qp, d_kp.to(k_p.dtype), d_vp.to(v_p.dtype),
        d_x2d, d_wpv.to(w_pv.dtype), None, d_pa,
    ) + ((d_wpb,) if rest else ())


def _launch_backward(inputs, grad_outputs, scalar_w: float, pair_w: float, counted: bool = True):
    """Input gradients of :func:`ipa_attention` from :func:`backward_route`'s
    kernel on the current stream; raises if it cannot run. ``inputs`` are the
    operands on the card up to ``pa`` (ten), or with ``w_pb`` after it
    (eleven), ``grad_outputs`` ``(d_out_s, d_out_p, d_out_pair)``. With
    ``pa`` given, :func:`_launch_backward_tc`; with ``pa``
    None and ``w_pb`` given, :func:`_launch_backward_h4`. Counts the call in
    :data:`backward_calls_by_route` when ``counted`` (autograd's calls);
    ``chip_smoke.py`` and the card tests call it uncounted to compare.
    Returns :func:`ipa_attention_backward`'s gradients, one per input."""
    pa, w_pb = inputs[9], (inputs[10] if len(inputs) > 10 else None)
    if pa is None:
        if w_pb is None:
            raise ValueError("the backward kernels take the streamed pair bias (pa) or w_pb")
        return _launch_backward_h4(inputs, grad_outputs, scalar_w, pair_w, counted)
    grads = _launch_backward_tc(inputs[:10], grad_outputs, scalar_w, pair_w, counted)
    return grads + ((None,) if len(inputs) > 10 else ())


def _cotangents(q_s, grad_outputs, s_dtype):
    """The three cotangents, contiguous: ``d_out_s`` in ``s_dtype``,
    ``d_out_p`` and ``d_out_pair`` in f32; raises on a wrong shape or
    device."""
    B, H, Lq, dk = q_s.shape
    cts = (grad_outputs[0].to(s_dtype).contiguous(), grad_outputs[1].float().contiguous(),
           grad_outputs[2].float().contiguous())
    for name, t, shape in zip(("d_out_s", "d_out_p", "d_out_pair"), cts,
                              ((B, H, Lq, dk), (B, H, Lq, 24), (B, H, Lq, dk))):
        if tuple(t.shape) != shape or t.device != q_s.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, expected {shape} on "
                             f"{q_s.device}")
    return cts


def _launch_backward_tc(inputs, grad_outputs, scalar_w: float, pair_w: float, counted: bool):
    """:func:`_launch_backward` with the streamed pair bias: the kernel
    ``csrc/ipa_attention_bwd_tc.cu`` at 32 heads,
    ``csrc/ipa_attention_bwd_tc16.cu`` at 16,
    ``csrc/ipa_attention_bwd_tc8.cu`` at 8, each forming ``g_wx2d = ct_pr
    @ w_pv^T`` itself. The plain product after it, ``d_w_pv = wx2d^T
    ct_pr``, goes to ``torch.bmm``, as JAX leaves it to XLA. Returns ten
    gradients."""
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa = inputs
    _check(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, None)
    B, H, Lq, dk = q_s.shape
    Lk, Cp = k_s.shape[2], x2d.shape[-1]
    route = backward_route(q_s.dtype, H, dk, Cp, True)
    if route == "torch":
        raise ValueError(f"no backward kernel takes {H} heads, Cp={Cp} in {q_s.dtype}")
    f32, dev = torch.float32, q_s.device
    ct_s, ct_p, ct_pr = _cotangents(q_s, grad_outputs, q_s.dtype)
    if any(t.data_ptr() % 16 for t in (q_s, v_s, v_p, pa, ct_s, ct_p)):
        raise ValueError("the backward kernel needs 16-byte aligned q_s, v_s, v_p, pa and cotangents")
    ct_pr_h = ct_pr.transpose(0, 1).reshape(H, B * Lq, dk)      # heads first
    w_pv_in = w_pv.contiguous()  # with ct_pr, for g formed in the kernel
    if w_pv_in.data_ptr() % 16:
        raise ValueError(f"the {H}-head backward kernel needs a 16-byte aligned w_pv")
    d_qs, d_ks, d_vs = torch.empty_like(q_s), torch.empty_like(k_s), torch.empty_like(v_s)
    d_qp, d_kp, d_vp = torch.empty_like(q_p), torch.empty_like(k_p), torch.empty_like(v_p)
    d_x2d, d_pa = torch.empty_like(x2d), torch.empty_like(pa)
    wx2d = torch.empty((H, B * Lq, Cp), dtype=f32, device=dev)
    ds, logits, dvals = (torch.empty((B, H, Lq, Lk), dtype=f32, device=dev) for _ in range(3))
    stats = torch.empty((B, H, Lq, 2), dtype=f32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, _BWD_ROUTE_SYMBOLS[route])(
            *(t.data_ptr() for t in (q_s, k_s, v_s, q_p, k_p, v_p, x2d, bias, pa, ct_s, ct_p,
                                     ct_pr, w_pv_in, d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d,
                                     d_pa, wx2d, ds, logits, dvals, stats)),
            B, H, Lq, Lk, dk, Cp, float(scalar_w), float(pair_w),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ipa_attention backward kernel launch ({route}) failed: "
                           + lib.ipa_attention_error_string(err).decode())
    # d_w_pv = sum over (b, i) of wx2d^T ct_pr: one bmm a (head, batch element)
    # over its Lq rows, then the B partials summed in order (a bmm a head over
    # all B Lq rows gives the card too few tiles, each walking every row).
    d_wpv = torch.bmm(wx2d.view(H * B, Lq, Cp).transpose(1, 2),
                      ct_pr_h.view(H * B, Lq, dk)).view(H, B, Cp, dk).sum(1).to(w_pv.dtype)
    if counted:
        backward_calls_by_route[route] += 1
    return d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_wpv, None, d_pa


def _launch_backward_h4(inputs, grad_outputs, scalar_w: float, pair_w: float, counted: bool):
    """:func:`_launch_backward` with the pair bias computed in the kernel
    (``pa`` None, ``w_pb [Cp, 4]`` f32 last): the kernel
    ``csrc/ipa_attention_bwd_h4.cu`` (route ``"bwd_h4"``: f32, 4 heads,
    ``Cp <= H4_MAX_CP``), which computes every gradient itself, ``d_w_pv``
    and ``d_w_pb`` from its row blocks' partials added in a fixed order.
    Returns eleven gradients, ``d_w_pb`` last, shaped as ``w_pb``; None for
    the bias and ``pa``."""
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb = inputs
    _check(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb)
    B, H, Lq, dk = q_s.shape
    Lk, Cp = k_s.shape[2], x2d.shape[-1]
    route = backward_route(q_s.dtype, H, dk, Cp, False)
    if route != "bwd_h4":
        raise ValueError(f"no backward kernel takes {H} heads, Cp={Cp} in {q_s.dtype} with w_pb")
    f32, dev = torch.float32, q_s.device
    ct_s, ct_p, ct_pr = _cotangents(q_s, grad_outputs, f32)
    if any(t.data_ptr() % 16 for t in (q_s, v_s, v_p, w_pv, w_pb, ct_s, ct_p, ct_pr)):
        raise ValueError("the bwd_h4 kernel needs 16-byte aligned q_s, v_s, v_p, w_pv, w_pb and "
                         "cotangents")
    d_qs, d_ks, d_vs = torch.empty_like(q_s), torch.empty_like(k_s), torch.empty_like(v_s)
    d_qp, d_kp, d_vp = torch.empty_like(q_p), torch.empty_like(k_p), torch.empty_like(v_p)
    d_x2d, d_wpv, d_wpb = torch.empty_like(x2d), torch.empty_like(w_pv), torch.empty_like(w_pb)
    lib = _library()
    with torch.cuda.device(dev):
        blocks = lib.ipa_attention_bwd_h4_row_blocks(B, Lq, Cp)
        if blocks < 1:
            raise RuntimeError("the bwd_h4 kernel could not read the device")
        # Scratch: s and dphat, then a and ds, at a row stride of Lk rounded
        # up to 4; a row block's partials of d_w_pv and d_w_pb.
        a_buf, ds_buf = (torch.empty((B, H, Lq, -(-Lk // 4) * 4), dtype=f32, device=dev)
                         for _ in range(2))
        w_part = torch.empty((blocks, H * Cp * (dk + 1)), dtype=f32, device=dev)
        err = lib.ipa_attention_bwd_h4(
            *(t.data_ptr() for t in (q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, w_pb, ct_s,
                                     ct_p, ct_pr, d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_wpv,
                                     d_wpb, a_buf, ds_buf, w_part)),
            B, H, Lq, Lk, dk, Cp, float(scalar_w), float(pair_w),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ipa_attention backward kernel launch ({route}) failed: "
                           + lib.ipa_attention_error_string(err).decode())
    if counted:
        backward_calls_by_route[route] += 1
    return d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_wpv, None, None, d_wpb


def _backward(saved, grad_outputs, scalar_w: float, pair_w: float):
    """Autograd's backward of :func:`ipa_attention` on the saved operands
    (eleven, ``w_pb`` last): counts the pass and dispatches it, CPU tensors
    to :func:`ipa_attention_backward`, CUDA tensors by
    :func:`backward_route`. Returns eleven gradients."""
    global backward_calls
    backward_calls += 1
    q_s, x2d, pa = saved[0], saved[6], saved[9]
    route = "torch"
    if q_s.device.type == "cuda":
        route = backward_route(q_s.dtype, q_s.shape[1], q_s.shape[3], x2d.shape[-1], pa is not None)
    if route == "torch":
        backward_calls_by_route["torch"] += 1
        return ipa_attention_backward(saved, grad_outputs, scalar_w=scalar_w, pair_w=pair_w)
    return _launch_backward(saved, grad_outputs, scalar_w, pair_w)


def _tf32(x, trunc=False):
    """``x`` rounded to TF32 (10 fraction bits): to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds it, or with ``trunc`` toward zero,
    as the tensor cores read an f32 operand's bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits if trunc else bits + 0x1000) & -0x2000).view(torch.float32)


def _terms(x, model_dtype, trunc=False):
    """The two terms the backward kernel feeds its tensor cores for an f32
    operand ``x``: bf16 ``hi + lo`` for a bf16 model, TF32 ``big + small``
    for an f32 one (``trunc``: both terms truncated, the split of the
    streamed designs at 32, 16 and 8 heads and of bwd_h4)."""
    if model_dtype == torch.bfloat16:
        hi = x.to(torch.bfloat16).float()
        return hi, (x - hi).to(torch.bfloat16).float()
    big = _tf32(x, trunc)
    return big, _tf32(x - big, trunc)


def _tc_einsum(eq, a, b, model_dtype, b_exact, trunc=False):
    """``einsum(eq, a, b)`` as the backward kernel's tensor cores compute it:
    ``a`` as two terms; ``b`` as it is where ``b_exact`` (bf16 x2d), else as
    two terms too, the small x small product dropped."""
    a1, a2 = _terms(a, model_dtype, trunc)
    if b_exact:
        return torch.einsum(eq, a2, b) + torch.einsum(eq, a1, b)
    b1, b2 = _terms(b, model_dtype, trunc)
    return torch.einsum(eq, a2, b1) + torch.einsum(eq, a1, b2) + torch.einsum(eq, a1, b1)


def ipa_attention_backward_tiled(inputs, grad_outputs, *, scalar_w: float, pair_w: float,
                                 tile: int = 16):
    """Input gradients of :func:`ipa_attention` with the streamed pair bias,
    computed the way the backward kernels (``csrc/ipa_attention_bwd_tc.cu``
    at 32 heads, ``csrc/ipa_attention_bwd_tc16.cu`` at 16,
    ``csrc/ipa_attention_bwd_tc8.cu`` at 8) compute them; no
    path calls it (the CPU tests hold it against JAX's
    ``_fused_backward_chunked`` and :func:`ipa_attention_backward`).

    Where its algebra differs from :func:`ipa_attention_backward`: the row
    statistics come from a sweep of their own, online over key tiles of
    ``tile`` columns; the softmax's row term is ``D = sum_j a (ct_s.v_s +
    ct_p.v_p) + g.wx2d`` from the row aggregate ``wx2d``, ``g = ct_pr @
    w_pv^T``; the column sums use the same ``a`` (recomputed in the kernel
    from the saved statistics) and ``ds``; point distances are explicit
    differences; and the three x2d contractions take their operands as the
    tensor cores do (:func:`_tc_einsum`: bf16 x2d exact, f32 operands as
    two bf16 terms; in f32, 3xTF32, its terms truncated at 32, 16 and 8
    heads). Same arguments and result as
    :func:`ipa_attention_backward`, ``pa`` given."""
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa = inputs[:10]
    ct_s, ct_p, ct_pr = grad_outputs
    f32, dt = torch.float32, q_s.dtype
    B, H, Lq, _ = q_s.shape
    Lk = k_s.shape[2]
    bf = dt == torch.bfloat16
    qs, ks, x = q_s.float() * scalar_w, k_s.float(), x2d.float()
    diff = q_p.float()[..., :, None] - k_p.float()[..., None, :]  # [B, 3, H4, Lq, Lk]
    d2 = (diff * diff).sum(1)
    dist = torch.sqrt(d2.clamp_min(0.0) + 1e-24)
    s = (torch.einsum("bhid,bhjd->bhij", qs, ks) - dist.reshape(B, H, 4, Lq, Lk).sum(2)
         + pair_w * pa.float() + bias.float()[:, None, None, :])

    # Sweep 1: the row statistics, online over key tiles.
    m = torch.full((B, H, Lq), -1e30)
    total = torch.zeros(B, H, Lq)
    for j0 in range(0, Lk, tile):
        st = s[..., j0:j0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        total = total * torch.exp(m - m_new) + torch.exp(st - m_new[..., None]).sum(-1)
        m = m_new
    a = torch.exp(s - m[..., None]) * (1.0 / total)[..., None]

    # Sweep 2: wx2d and D from row aggregates.
    g = torch.einsum("bhid,hpd->bhip", ct_pr.float(), w_pv.float())
    trunc = H in (32, 16, 8)  # the streamed designs split f32 operands by truncation
    wx2d = _tc_einsum("bhij,bijp->bhip", a, x, dt, b_exact=bf, trunc=trunc)
    dv = (torch.einsum("bhid,bhjd->bhij", ct_s.float(), v_s.float())
          + torch.einsum("bhic,bhjc->bhij", ct_p.float(), v_p.float()))
    g_held = sum(_terms(g, dt)) if bf else g  # the bf16 kernel holds g as hi + lo
    D = (a * dv).sum(-1) + (g_held * wx2d).sum(-1)

    # Sweep 3: ds, the row gradients and d_x2d.
    ds = a * (dv + _tc_einsum("bhip,bijp->bhij", g, x, dt, b_exact=bf, trunc=trunc)
              - D[..., None])
    inv = torch.where(d2 > 0.0, 1.0 / torch.sqrt(d2 + 1e-24), torch.zeros_like(d2))
    w = ((-ds)[:, :, None] * inv.reshape(B, H, 4, Lq, Lk)).reshape(B, -1, Lq, Lk)[:, None] * diff
    d_x2d = _tc_einsum("bhij,bhip->bijp", a, g, dt, b_exact=False, trunc=trunc)

    # The column sums, from the same a and ds.
    return (
        (scalar_w * torch.einsum("bhij,bhjd->bhid", ds, ks)).to(dt),
        torch.einsum("bhij,bhid->bhjd", ds, qs).to(k_s.dtype),
        torch.einsum("bhij,bhid->bhjd", a, ct_s.float()).to(v_s.dtype),
        w.sum(-1).to(q_p.dtype),
        (-w.sum(-2)).to(k_p.dtype),
        torch.einsum("bhij,bhic->bhjc", a, ct_p.float()).to(v_p.dtype),
        d_x2d.to(x2d.dtype),
        torch.einsum("bhip,bhid->hpd", wx2d, ct_pr.float()).to(w_pv.dtype),
        None,
        (pair_w * ds).to(pa.dtype),
    )


def ipa_attention_backward_h4_tiled(inputs, grad_outputs, *, scalar_w: float, pair_w: float,
                                    tile: int = 16, rows: int = 8, tf32: bool = True):
    """Input gradients of :func:`ipa_attention` with the pair bias computed
    in the kernel (``pa`` None, ``w_pb`` last), computed the way the backward
    kernel ``csrc/ipa_attention_bwd_h4.cu`` computes them; no path calls it
    (the CPU tests hold it against JAX's ``_fused_backward_chunked`` and
    :func:`ipa_attention_backward`).

    Where its algebra differs from :func:`ipa_attention_backward`: the
    logit's terms outside x2d (``q.k``, the point distances, the column
    bias) and the value terms ``dv`` come first; one sweep over key tiles of
    ``tile`` columns adds the x2d products to them and carries, online, the
    row statistics, ``sum_j p dphat`` (so ``D`` is that over the sum), ``U =
    sum_j p x2d`` and ``V = sum_j p dphat x2d``; ``wx2d`` is ``U`` over the
    sum and a row's ``sum_j ds x2d`` is ``(V - D U)`` over the sum, so
    ``d_w_pb`` needs no second pass over x2d: each block of ``rows`` query
    rows adds its rows' terms in row order, and the blocks' partials are
    added in order. The pair bias takes ``w_pb`` times ``pair_w``, as the
    kernel holds it; point distances are explicit differences; ``d_x2d = a g
    + ds (pair_w w_pb)`` with ``g = ct_pr @ w_pv^T``. With ``tf32`` the x2d
    products (the pair bias, ``g . x2d``, ``U``, ``V`` and ``d_x2d``) take
    their operands as the kernel's tensor cores do (:func:`_tc_einsum`:
    3xTF32, both terms truncated); without it they are f32. Same arguments
    and result as :func:`ipa_attention_backward` with ``w_pb`` given (eleven
    gradients)."""
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, _, w_pb = inputs
    ct_s, ct_p, ct_pr = (c.float() for c in grad_outputs)
    B, H, Lq, _ = q_s.shape
    Lk, Cp = k_s.shape[2], x2d.shape[-1]
    qs, ks, x = q_s.float() * scalar_w, k_s.float(), x2d.float()
    wpb = w_pb.float() * pair_w
    if tf32:
        def mm(eq, a, b):
            return _tc_einsum(eq, a, b, torch.float32, b_exact=False, trunc=True)
    else:
        mm = torch.einsum
    diff = q_p.float()[..., :, None] - k_p.float()[..., None, :]  # [B, 3, H4, Lq, Lk]
    d2 = (diff * diff).sum(1)
    dist = torch.sqrt(d2.clamp_min(0.0) + 1e-24)
    g = torch.einsum("bhid,hcd->bhic", ct_pr, w_pv.float())
    # The terms outside x2d, then the x2d products added to them.
    s = (torch.einsum("bhid,bhjd->bhij", qs, ks) - dist.reshape(B, H, 4, Lq, Lk).sum(2)
         + bias.float()[:, None, None, :]) + mm("bijc,ch->bhij", x, wpb)
    dphat = (torch.einsum("bhid,bhjd->bhij", ct_s, v_s.float())
             + torch.einsum("bhic,bhjc->bhij", ct_p, v_p.float())) + mm("bijc,bhic->bhij", x, g)

    # Sweep 1: the statistics, D's sum and the x2d aggregates, online.
    m = torch.full((B, H, Lq), -1e30)
    total, pd = torch.zeros(B, H, Lq), torch.zeros(B, H, Lq)
    U, V = torch.zeros(B, H, Lq, Cp), torch.zeros(B, H, Lq, Cp)
    for j0 in range(0, Lk, tile):
        st, dt, xt = s[..., j0:j0 + tile], dphat[..., j0:j0 + tile], x[:, :, j0:j0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        total = total * corr + p.sum(-1)
        pd = pd * corr + (p * dt).sum(-1)
        U = U * corr[..., None] + mm("bhij,bijc->bhic", p, xt)
        V = V * corr[..., None] + mm("bhij,bijc->bhic", p * dt, xt)
        m = m_new
    inv = 1.0 / total
    D = pd * inv

    # d_w_pb: each row's pair_w (V - D U) / sum; a block's rows in order,
    # then the blocks (batch element first) in order.
    term = pair_w * (V - D[..., None] * U) * inv[..., None]     # [B, H, Lq, Cp]
    nblk = -(-Lq // rows)
    term = torch.nn.functional.pad(term, (0, 0, 0, nblk * rows - Lq))
    term = term.reshape(B, H, nblk, rows, Cp)
    part = torch.zeros(B, H, nblk, Cp)
    for r in range(rows):
        part = part + term[:, :, :, r]
    d_wpb = torch.zeros(H, Cp)
    for p_ in part.permute(0, 2, 1, 3).reshape(B * nblk, H, Cp):
        d_wpb = d_wpb + p_

    # Sweep 2: a and ds from the kept s and dphat; d_x2d and the rows' sums.
    a = torch.exp(s - m[..., None]) * inv[..., None]
    ds = a * (dphat - D[..., None])
    d_x2d = mm("bhij,bhic->bijc", a, g) + mm("bhij,ch->bijc", ds, wpb)
    inv_dist = torch.where(d2 > 0.0, 1.0 / torch.sqrt(d2 + 1e-24), torch.zeros_like(d2))
    w = ((-ds)[:, :, None] * inv_dist.reshape(B, H, 4, Lq, Lk)).reshape(B, -1, Lq, Lk)[:, None] * diff
    wx2d = U * inv[..., None]

    # The column sums, from the same a and ds.
    return (
        scalar_w * torch.einsum("bhij,bhjd->bhid", ds, ks),
        torch.einsum("bhij,bhid->bhjd", ds, qs),
        torch.einsum("bhij,bhid->bhjd", a, ct_s),
        w.sum(-1),
        -w.sum(-2),
        torch.einsum("bhij,bhic->bhjc", a, ct_p),
        d_x2d,
        torch.einsum("bhic,bhid->hcd", wx2d, ct_pr),
        None,
        None,
        d_wpb.t().contiguous(),
    )


class _IPAAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward and the
    backward :func:`_backward` dispatches. The operands are saved by reference:
    ``x2d``, shared by every layer, is not copied. One of ``pa`` and
    ``w_pb`` is None."""

    @staticmethod
    def forward(ctx, q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb, scalar_w, pair_w):
        args = (q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb)
        if q_s.device.type == "cpu":
            outs = ipa_attention_plain(*args, scalar_w=scalar_w, pair_w=pair_w)
        elif q_s.device.type == "cuda":
            outs = _launch_kernel(*args, scalar_w, pair_w)
        else:
            raise ValueError(f"ipa_attention runs on cpu or cuda, not {q_s.device}")
        ctx.save_for_backward(*args)
        ctx.scalar_w, ctx.pair_w = scalar_w, pair_w
        return outs

    @staticmethod
    def backward(ctx, ct_s, ct_p, ct_pr):
        grads = _backward(ctx.saved_tensors, (ct_s, ct_p, ct_pr), ctx.scalar_w, ctx.pair_w)
        return (
            *(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
            None, None,
        )


def ipa_attention(
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa=None, w_pb=None, *,
    scalar_w: float, pair_w: float,
):
    """Fused IPA attention core. Returns ``(out_s, out_p, out_pair)``.

    Exactly one of ``pa`` (the streamed pair bias) and ``w_pb`` (the pair
    bias computed in the kernel as ``x2d @ w_pb``) is given, as in JAX's
    ``fused_ipa_attention``. CPU operands run :func:`ipa_attention_plain`.
    CUDA operands launch the Hopper kernel on the current stream, or raise
    if it cannot be built, does not take these shapes, or fails to launch.
    Differentiable in every operand but ``bias``: the backward is
    :func:`ipa_attention_backward` or, on CUDA tensors of the widths
    :func:`backward_route` names, the backward kernel.
    """
    if (pa is None) == (w_pb is None):
        raise ValueError("give exactly one of pa (streamed pair bias) and w_pb (in-kernel)")
    return _IPAAttention.apply(
        q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb, scalar_w, pair_w
    )


def sp_ipa_attention(
    rows: tuple[int, int], q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa=None,
    w_pb=None, *, scalar_w: float, pair_w: float,
):
    """Sequence-parallel IPA attention on one rank: query rows ``r0:r1`` of
    ``Lk`` against every column. Counterpart of
    ``se3diff_tpu/ops/pallas_ipa.py::sp_fused_ipa_attention``, whose
    ``shard_map`` hands each device the same operands.

    ``q_s``, ``q_p``, ``x2d`` and ``pa`` are the slab's rows (``r1 - r0`` of
    them); ``k_s``, ``v_s``, ``k_p``, ``v_p`` and ``bias`` hold all ``Lk``
    columns. With ``w_pb`` in place of ``pa`` (``pa=None``, as JAX's
    function accepts) the kernel computes the slab's pair bias itself. The slab goes through :func:`ipa_attention` as it is: the kernel
    takes ``Lq != Lk`` and masks a ragged last row tile itself, so no row is
    padded. Returns the slab's three outputs. ``rows = (0, Lk)`` (one rank)
    is plain :func:`ipa_attention`, as the JAX function falls back when the
    row axis is unsharded. No collective runs here: the ranks' output rows
    are disjoint.
    """
    r0, r1 = rows
    Lk = k_s.shape[2]
    if not 0 <= r0 < r1 <= Lk:
        raise ValueError(f"row slab {rows} is not inside the {Lk} columns")
    for name, t, dim in (("q_s", q_s, 2), ("q_p", q_p, 3), ("x2d", x2d, 1), ("pa", pa, 2)):
        if t is not None and t.shape[dim] != r1 - r0:
            raise ValueError(f"{name} has {t.shape[dim]} rows, the slab {rows} {r1 - r0}")
    return ipa_attention(
        q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb, scalar_w=scalar_w, pair_w=pair_w
    )
