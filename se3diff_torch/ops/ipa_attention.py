"""Fused IPA attention core: the CUDA kernel for Hopper and its plain version.

Counterpart of ``se3diff_tpu/ops/pallas_ipa.py::fused_ipa_attention`` with the
streamed pair bias (``has_pa=True``), whose Pallas body is ``_kernel``. For
query rows i, key columns j and heads h:

    s[h,i,j] = scalar_w <q_s, k_s> - sum_{p<4} |q_p - k_p| + pair_w pa + bias[j]
    a        = softmax_j(s)                         (f32)
    out_s    = sum_j a v_s                          [B, H, Lq, dk]  model dtype
    out_p    = sum_j a v_p                          [B, H, Lq, 24]  f32
    out_pair = (sum_j a x2d[i, j, :]) @ w_pv[h]     [B, H, Lq, dk]  model dtype

Operands keep the JAX kernel's layout: q/k/v_s ``[B, H, L, dk]`` (model
dtype), point planes ``[B, 3, H*4, L]`` f32 pre-scaled by half the per-head
point weight, ``v_p [B, H, Lk, 24]`` f32, ``x2d [B, Lq, Lk, Cp]`` and
``pa [B, H, Lq, Lk]`` (model dtype), ``w_pv [H, Cp, dk]`` (model dtype) and a
column ``bias [B, Lk]`` f32 holding :data:`NEG_INF` at masked columns.

:func:`ipa_attention` dispatches on the device of its operands alone: CPU
tensors go through :func:`ipa_attention_plain`; CUDA tensors launch the
kernel in ``csrc/ipa_attention.cu`` (built with ``nvcc`` for ``sm_90a`` at
first use, bound through ``ctypes``) or raise. The kernel takes 32 heads of
width 16 and ``Cp <= 256`` (the bioemu-v1.0 widths).
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
    "ipa_attention_plain",
    "build_library",
]

# Finite mask value for column biases: the online softmax never meets inf-inf.
NEG_INF = -1e30

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ipa_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches made through ipa_attention (plain-version calls do not count).
launches = 0

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the IPA attention kernel cannot be built")


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/ipa_attention.cu`` into ``_build/`` unless a library of
    the same source is already there. Returns ``(path, compiler log)``; the
    log holds ptxas's register and shared-memory report after a fresh build."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libipa_attention_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {SOURCE}:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ipa_attention_fwd.argtypes = [vp] * 13 + [ci] * 7 + [cf, cf, vp]
            lib.ipa_attention_fwd.restype = ci
            lib.ipa_attention_error_string.argtypes = [ci]
            lib.ipa_attention_error_string.restype = ctypes.c_char_p
            lib.ipa_attention_heads.restype = ci
            lib.ipa_attention_head_dim.restype = ci
            _lib = lib
        return _lib


def ipa_attention_plain(
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, *, scalar_w: float, pair_w: float
):
    """Plain PyTorch version, counterpart of ``_fused_semantics_jnp``.

    Model-dtype operands are upcast to f32 before each contraction, which for
    bf16 is exact (bf16 products fit in f32): bf16 operands, f32 sums. The
    softmax weights that multiply ``v_s`` and ``x2d`` are rounded to the
    model dtype first, as in the kernel.
    """
    f32 = torch.float32
    B, H, Lq, _ = q_s.shape
    s = torch.einsum("bhid,bhjd->bhij", q_s.to(f32), k_s.to(f32)) * scalar_w

    qp, kp = q_p.to(f32), k_p.to(f32)
    q2 = (qp * qp).sum(1)                                   # [B, H*4, Lq]
    k2 = (kp * kp).sum(1)                                   # [B, H*4, Lk]
    qk = torch.einsum("bxpi,bxpj->bpij", qp, kp)            # [B, H*4, Lq, Lk]
    d2 = q2[..., :, None] + k2[..., None, :] - 2.0 * qk
    d2 = torch.where(d2 > 0.0, d2, torch.full_like(d2, 1e-24))
    pdist = torch.sqrt(d2).reshape(B, H, 4, Lq, -1).sum(2)  # [B, H, Lq, Lk]
    s = s - pdist + pair_w * pa.to(f32) + bias.to(f32)[:, None, None, :]

    a = torch.softmax(s, dim=-1)
    a16 = a.to(v_s.dtype).to(f32)
    out_s = torch.einsum("bhij,bhjd->bhid", a16, v_s.to(f32)).to(q_s.dtype)
    out_p = torch.einsum("bhij,bhjc->bhic", a, v_p.to(f32))
    wx2d = torch.einsum("bhij,bijp->bhip", a16, x2d.to(f32))
    out_pair = torch.einsum("bhip,hpd->bhid", wx2d, w_pv.to(f32)).to(q_s.dtype)
    return out_s, out_p, out_pair


def _check(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa) -> None:
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
        "pa": (pa, (B, H, Lq, Lk), dt),
    }
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


def ipa_attention(
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, *, scalar_w: float, pair_w: float
):
    """Fused IPA attention core. Returns ``(out_s, out_p, out_pair)``.

    CPU operands run :func:`ipa_attention_plain`. CUDA operands launch the
    Hopper kernel on the current stream, or raise if it cannot be built,
    does not take these shapes, or fails to launch.
    """
    global launches
    if q_s.device.type == "cpu":
        return ipa_attention_plain(
            q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa,
            scalar_w=scalar_w, pair_w=pair_w,
        )
    if q_s.device.type != "cuda":
        raise ValueError(f"ipa_attention runs on cpu or cuda, not {q_s.device}")
    _check(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa)
    lib = _library()
    B, H, Lq, dk = q_s.shape
    Lk, Cp = k_s.shape[2], x2d.shape[-1]
    if (H, dk) != (lib.ipa_attention_heads(), lib.ipa_attention_head_dim()) or Cp > 256:
        raise ValueError(
            f"the kernel takes {lib.ipa_attention_heads()} heads of width "
            f"{lib.ipa_attention_head_dim()} and Cp <= 256; got H={H}, dk={dk}, Cp={Cp}"
        )
    out_s = torch.empty_like(q_s)
    out_p = torch.empty((B, H, Lq, 24), dtype=torch.float32, device=q_s.device)
    out_pair = torch.empty_like(q_s)
    with torch.cuda.device(q_s.device):
        err = lib.ipa_attention_fwd(
            q_s.data_ptr(), k_s.data_ptr(), v_s.data_ptr(), q_p.data_ptr(),
            k_p.data_ptr(), v_p.data_ptr(), x2d.data_ptr(), w_pv.data_ptr(),
            bias.data_ptr(), pa.data_ptr(), out_s.data_ptr(), out_p.data_ptr(),
            out_pair.data_ptr(), B, H, Lq, Lk, dk, Cp,
            int(q_s.dtype == torch.bfloat16), float(scalar_w), float(pair_w),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "ipa_attention kernel launch failed: "
            + lib.ipa_attention_error_string(err).decode()
        )
    launches += 1
    return out_s, out_p, out_pair
