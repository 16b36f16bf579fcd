"""K1 at the training example's widths (4 heads of width 8, Cp=16): the
port's plain version and its backward against the JAX package, and the
sources of the 4-head designs at those widths.

``examples/train_from_scratch.py`` trains ``dim_model=32, dim_pair=16,
num_heads=4``; on the card its attention takes route "h4s" (the streamed
pair bias, ``csrc/ipa_attention_h4.cu``) and its backward "bwd_h4s"
(``csrc/ipa_attention_bwd_h4.cu``), and "h4" / "bwd_h4" take the same widths
with the pair bias computed in the kernel. The kernels run on the card only
(``tests/test_torch_kernel_cuda.py``); here the plain version, the PyTorch
backward and the backward kernel's algebra in PyTorch
(``ipa_attention_backward_h4_tiled``) are held against JAX on the same numpy
inputs in the kernel layout:

* forward: ``ipa_attention`` on CPU tensors against ``fused_ipa_attention``
  in interpret mode, the pair bias streamed and computed in the kernel, f32
  and bf16, square, ragged (padded for the JAX kernel) and masked. Tolerance
  ``tests/test_torch_ipa_attention.py``'s: f32 2e-5, bf16 3e-2;
* backward: ``ipa_attention_backward`` against ``jax.grad`` through
  ``fused_ipa_attention_diff`` (interpret mode) of the outputs' inner
  product with the cotangents. Tolerance ``tests/test_torch_ipa_backward.py``'s:
  f32 1e-4 absolute and 1e-3 relative; bf16 1e-2 x max(1, max|JAX|).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import ipa_attention as k1
from se3diff_tpu.ops.pallas_ipa import NEG_INF, fused_ipa_attention, fused_ipa_attention_diff

CSRC = Path(k1.__file__).resolve().parents[1] / "csrc"
H, DK, CP = 4, 8, 16
KW = dict(scalar_w=1.0 / np.sqrt(3 * DK), pair_w=1.0 / np.sqrt(3))
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
NAMES = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa", "w_pb")
MODEL_DTYPE = ("q_s", "k_s", "v_s", "x2d", "w_pv", "pa")
# JAX's operands: w_pb before w_pv, pa last.
JAX_ORDER = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pb", "w_pv", "bias", "pa")


def _inputs(rng, B, Lq, Lk, masked_cols=0, cp=CP):
    """Kernel-layout operands (float32 numpy; ``pa = x2d @ w_pb``) and the
    three cotangents."""
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    if masked_cols:
        bias[:, -masked_cols:] = NEG_INF
    a = dict(
        q_s=g(B, H, Lq, DK), k_s=g(B, H, Lk, DK), v_s=g(B, H, Lk, DK),
        q_p=g(B, 3, H * 4, Lq, scale=0.6), k_p=g(B, 3, H * 4, Lk, scale=0.6),
        v_p=g(B, H, Lk, 24), x2d=g(B, Lq, Lk, cp, scale=0.5),
        w_pv=g(H, cp, DK, scale=0.3), bias=bias, w_pb=g(cp, H, scale=0.3),
    )
    a["pa"] = np.einsum("bijp,ph->bhij", a["x2d"], a["w_pb"]).astype(np.float32)
    ct = (g(B, H, Lq, DK), g(B, H, Lq, 24), g(B, H, Lq, DK))
    return a, ct


def _torch_args(a, dtype, streamed):
    """``ipa_attention``'s eleven operands: ``pa`` or ``w_pb`` None."""
    md = getattr(torch, dtype)
    out = []
    for n in NAMES:
        if n == ("w_pb" if streamed else "pa"):
            out.append(None)
        else:
            out.append(torch.from_numpy(a[n]).to(md if n in MODEL_DTYPE else torch.float32))
    return out


def _jax_args(a, dtype, streamed):
    md = getattr(jnp, dtype)
    out = [jnp.asarray(a[n]).astype(md if n in MODEL_DTYPE else jnp.float32) for n in JAX_ORDER]
    if not streamed:
        out[-1] = None
    return out


def _pad(a, Lq, Lk):
    """JAX's operands padded to (Lq, Lk): zero rows and columns, NEG_INF
    bias columns (the Pallas kernel needs tile-multiple shapes)."""
    def pad(x, axis, n, value=0.0):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, n - x.shape[axis])
        return np.pad(x, widths, constant_values=value)

    out = dict(a, q_s=pad(a["q_s"], 2, Lq), q_p=pad(a["q_p"], 3, Lq), k_p=pad(a["k_p"], 3, Lk),
               bias=pad(a["bias"], 1, Lk, NEG_INF), x2d=pad(pad(a["x2d"], 1, Lq), 2, Lk),
               pa=pad(pad(a["pa"], 2, Lq), 3, Lk))
    for k in ("k_s", "v_s", "v_p"):
        out[k] = pad(a[k], 2, Lk)
    return out


@pytest.mark.parametrize("streamed", [True, False], ids=["pa", "w_pb"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Lq,Lk,pad_to,masked", [
    (8, 8, 8, 8, 0),       # the training example's batch: B=8, L=8
    (2, 10, 10, 16, 3),    # ragged L with masked columns, padded for the JAX kernel
    (2, 12, 16, 16, 5),    # rows != columns (a row slab), masked columns
])
def test_plain_matches_pallas_kernel_at_the_example_widths(rng, dtype, streamed, B, Lq, Lk,
                                                           pad_to, masked):
    a, _ = _inputs(rng, B, Lq, Lk, masked)
    route = k1.kernel_route(getattr(torch, dtype), H, DK, CP, streamed)
    assert route == ("simt" if dtype == "bfloat16" else "h4s" if streamed else "h4")
    got = k1.ipa_attention(*_torch_args(a, dtype, streamed), **KW)
    ja = _pad(a, pad_to, max(pad_to, Lk))
    want = fused_ipa_attention(*_jax_args(ja, dtype, streamed), **KW, ti=8, tj=8, interpret=True)
    for g, w, name in zip(got, want, ("scalar", "point", "pair")):
        assert g.shape == (B, H, Lq, DK if name != "point" else 24), name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32)[:, :, :Lq],
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


def _jax_grads(a, ct, dtype, streamed):
    """``jax.grad`` through ``fused_ipa_attention_diff`` (interpret mode,
    its chunked backward: XLA's CPU backend has no batched bf16 x bf16 -> f32
    dot for the other) of sum(out_s ct_s) + sum(out_p ct_p) + sum(out_pair
    ct_pr), by operand name (JAX's own gradient of the column bias
    included)."""
    args = _jax_args(a, dtype, streamed)
    names = [n for n, x in zip(JAX_ORDER, args) if x is not None]
    md = getattr(jnp, dtype)
    cts = (jnp.asarray(ct[0]).astype(md), jnp.asarray(ct[1]), jnp.asarray(ct[2]).astype(md))

    def loss(*xs):
        full = dict(zip(names, xs))
        outs = fused_ipa_attention_diff(*(full.get(n) for n in JAX_ORDER), **KW, ti=8, tj=8,
                                        interpret=True, backward="chunked")
        return sum(jnp.sum(o.astype(jnp.float32) * c.astype(jnp.float32))
                   for o, c in zip(outs, cts))

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(*[x for x in args if x is not None])
    return dict(zip(names, grads))


@pytest.mark.parametrize("streamed", [True, False], ids=["pa", "w_pb"])
@pytest.mark.parametrize("dtype,B,L,masked", [
    ("float32", 8, 8, 0),      # the training example's batch
    ("float32", 2, 16, 5),     # masked columns, two key tiles of 8
    ("bfloat16", 2, 8, 3),
])
def test_backward_matches_jax_grad_at_the_example_widths(rng, dtype, streamed, B, L, masked):
    a, ct = _inputs(rng, B, L, L, masked)
    md = getattr(torch, dtype)
    ins = _torch_args(a, dtype, streamed)
    cts = (torch.from_numpy(ct[0]).to(md), torch.from_numpy(ct[1]), torch.from_numpy(ct[2]).to(md))
    route = k1.backward_route(md, H, DK, CP, streamed)
    assert route == ("torch" if dtype == "bfloat16" else "bwd_h4s" if streamed else "bwd_h4")
    got = k1.ipa_attention_backward(ins, cts, **KW)
    want = _jax_grads(a, ct, dtype, streamed)
    assert got[NAMES.index("bias")] is None
    assert (got[NAMES.index("pa")] is None) != streamed
    for name, g, p in zip(NAMES, got, ins):
        if name == "bias" or p is None:
            continue
        assert g.dtype == p.dtype and g.shape == p.shape, name
        w = np.asarray(want[name].astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(g.float().numpy(), w, atol=1e-4, rtol=1e-3, err_msg=name)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            assert np.abs(g.float().numpy() - w).max() <= 1e-2 * scale, name


@pytest.mark.parametrize("B,Lq,Lk,masked", [(8, 8, 8, 0), (2, 13, 13, 3), (2, 11, 20, 4),
                                            (1, 70, 70, 6)])
def test_streamed_h4_algebra_matches_jax_grad(rng, B, Lq, Lk, masked):
    """The backward kernel's algebra with the streamed pair bias
    (``ipa_attention_backward_h4_tiled`` with ``pa``: the logits take pair_w
    pa, d_x2d the aggregate term alone, d_pa = pair_w ds), its x2d products
    taken as the kernel's tensor cores take them, against ``jax.grad``
    through ``fused_ipa_attention_diff`` and against
    ``ipa_attention_backward`` (f32: 1e-4 absolute, 1e-3 relative). L=70
    spans two of the kernel's key chunks of 64."""
    a, ct = _inputs(rng, B, Lq, Lk, masked)
    ins = _torch_args(a, "float32", True)[:10]
    cts = tuple(torch.from_numpy(c) for c in ct)
    got = k1.ipa_attention_backward_h4_tiled(ins, cts, **KW)
    port = k1.ipa_attention_backward(ins, cts, **KW)
    assert len(got) == len(port) == 10
    ja = _pad(a, -(-Lq // 8) * 8, -(-Lk // 8) * 8)
    want = _jax_grads(ja, ct if Lq % 8 == 0 else tuple(
        np.pad(c, [(0, 0), (0, 0), (0, -Lq % 8), (0, 0)]) for c in ct), "float32", True)
    crop = {"q_s": (slice(None),) * 2 + (slice(0, Lq),), "q_p": (Ellipsis, slice(0, Lq)),
            "k_s": (slice(None),) * 2 + (slice(0, Lk),), "v_s": (slice(None),) * 2 + (slice(0, Lk),),
            "v_p": (slice(None),) * 2 + (slice(0, Lk),), "k_p": (Ellipsis, slice(0, Lk)),
            "x2d": (slice(None), slice(0, Lq), slice(0, Lk)),
            "pa": (slice(None), slice(None), slice(0, Lq), slice(0, Lk)), "w_pv": (Ellipsis,)}
    for name, g, other in zip(NAMES, got, port):
        if g is None:
            continue
        w = np.asarray(want[name], np.float32)[crop[name]]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(g.numpy(), other.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


def _h4_smem(cp, dk, in_kernel, rows=56, H=4):
    """``Layout<kH, kDK, kPb>(Cp, TI).total`` of ``csrc/ipa_attention_h4.cu``:
    two x2d stages [rows][4 Cp], the key chunk (k_s and v_s [H][64 dk + 8],
    v_p [H][64 * 24 + 8], the key points [64][16 H], the bias [64]), w_pv
    [H][Cp dk + 4], and streamed, two pair-bias stages [rows][H][4]."""
    stages = 2
    key = 2 * H * (64 * dk + 8) + H * (64 * 24 + 8) + 64 * 16 * H + 64
    total = 4 * (stages * rows * 4 * cp + key + H * (cp * dk + 4))
    return total + (0 if in_kernel else 4 * stages * rows * H * 4)


def _bwd_h4_smem(cp, dk, H=4):
    """``rows_smem_bytes<kH, kDK>(Cp)`` of ``csrc/ipa_attention_bwd_h4.cu``:
    8 warps' x2d stages (two at Cp <= 32, one above) [16][Cp16 + 8] and W
    [Cp16][8] (the mma tiles' 4 heads at any H), the rows' query side
    [8][H][68 or 52 + dk], s and dphat [8][H][72] each, k_s [H][64 dk + 4]
    and the key points [4][3][H][72]."""
    c16 = -(-cp // 16) * 16
    warp = (1 if cp > 32 else 2) * 16 * (c16 + 8) + c16 * 8
    block = 8 * H * (3 * dk + 24 + 12) + 2 * 8 * H * 72 + H * (64 * dk + 4) + 4 * 3 * H * 72
    return 4 * (8 * warp + block)


def test_h4_sources_state_the_example_widths_and_their_shared_memory():
    """The forward and backward 4-head sources instantiate head widths 8 and
    16, the in-kernel and the streamed variants, with one C entry each
    (``ipa_attention_h4s_fwd``, ``ipa_attention_bwd_h4s``: the arguments of
    their in-kernel twins), and the shared memory their headers state is
    their layouts' at both widths, within what one block may opt into on
    Hopper (232,448 bytes; the backward's row kernel two blocks an SM); so
    are the streamed instances' at 2 and 1 heads (a tensor-parallel rank
    of the example; "h2s", "h1s", "bwd_h2s", "bwd_h1s"), whose C entries
    take the same arguments. The card tests hold the library's exported
    sizes to the same numbers."""
    fwd = (CSRC / "ipa_attention_h4.cu").read_text()
    bwd = (CSRC / "ipa_attention_bwd_h4.cu").read_text()
    for text, inst in ((fwd, "launch<kH, {c}, {d}, kPb>"), (bwd, "launch<kH, {c}, {d}, kPb>")):
        for d in (8, 16):
            for c in (32, 64):
                assert inst.format(c=c, d=d) in text, (inst, c, d)
    for text, entries in ((fwd, ("ipa_attention_h4_fwd", "ipa_attention_h4s_fwd",
                                 "ipa_attention_h2s_fwd", "ipa_attention_h1s_fwd")),
                          (bwd, ("ipa_attention_bwd_h4", "ipa_attention_bwd_h4s",
                                 "ipa_attention_bwd_h2s", "ipa_attention_bwd_h1s"))):
        block = "".join(re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S))
        commas = set()
        for name in entries:
            found = [m.start() for m in re.finditer(rf"\bint {name}\(", block)]
            assert len(found) == 1, name
            sig = block[found[0]:]
            commas.add(sig[:sig.index(")")].count(","))
        assert len(commas) == 1, entries
    assert k1._ROUTE_SYMBOLS["h4s"] == "ipa_attention_h4s_fwd"
    assert k1._BWD_ROUTE_SYMBOLS["bwd_h4s"] == "ipa_attention_bwd_h4s"
    for H in (2, 1):
        assert k1._ROUTE_SYMBOLS[f"h{H}s"] == f"ipa_attention_h{H}s_fwd"
        assert k1._BWD_ROUTE_SYMBOLS[f"bwd_h{H}s"] == f"ipa_attention_bwd_h{H}s"

    stated = {
        (16, True): re.search(r"Shared memory at Cp = 32: ([\d,]+) bytes for 56 rows\.\n"
                              r"// Shared memory at Cp = 64: ([\d,]+) bytes", fwd).groups(),
        (8, True): re.search(r"at width 8 ([\d,]+) and ([\d,]+) bytes\.\)", fwd).groups(),
    }
    m = re.search(r"Shared memory of the streamed variant at Cp = 64: ([\d,]+) bytes for 56 rows "
                  r"\(width 16\),\n// ([\d,]+) \(width 8\); at Cp = 32 ([\d,]+) and ([\d,]+)\.", fwd)
    stated[16, False] = (m.group(3), m.group(1))
    stated[8, False] = (m.group(4), m.group(2))
    for (dk, in_kernel), (at32, at64) in stated.items():
        for cp, text in ((32, at32), (64, at64)):
            n = int(text.replace(",", ""))
            assert n == _h4_smem(cp, dk, in_kernel) and n <= 232_448, (dk, in_kernel, cp)
    m = re.search(r"Shared memory of bwd_h4_rows: ([\d,]+) bytes at Cp = 32 \(8 rows\), ([\d,]+) "
                  r"at Cp = 64 \(8 rows\)\.\n// \(At width 16; at width 8 ([\d,]+) and ([\d,]+) "
                  r"bytes", bwd)
    for (cp, dk), text in zip(((32, 16), (64, 16), (32, 8), (64, 8)), m.groups()):
        n = int(text.replace(",", ""))
        assert n == _bwd_h4_smem(cp, dk) and n <= 233_472 // 2 - 1024, (cp, dk)

    # The streamed instances at 2 heads (56 rows, 7 warps a block) and at 1
    # head (64 rows, 4 warps), Cp = 64.
    m = re.search(r"Shared memory of the streamed variant at 2 heads, Cp = 64: ([\d,]+) bytes for 56 "
                  r"rows \(width\n// 16\), ([\d,]+) \(width 8\); at 1 head ([\d,]+) bytes for 64 rows "
                  r"\(width 16\), ([\d,]+) \(width 8\)\.", fwd)
    for (H, dk, rows), text in zip(((2, 16, 56), (2, 8, 56), (1, 16, 64), (1, 8, 64)), m.groups()):
        n = int(text.replace(",", ""))
        assert n == _h4_smem(64, dk, False, rows, H) and n <= 232_448, (H, dk)
    m = re.search(r"// At 2 heads ([\d,]+) and ([\d,]+) bytes \(width 16\), ([\d,]+) and ([\d,]+) "
                  r"\(width 8\); at 1 head\n// ([\d,]+) and ([\d,]+) \(width 16\), ([\d,]+) and "
                  r"([\d,]+) \(width 8\)\.", bwd)
    shapes = [(H, dk, cp) for H in (2, 1) for dk in (16, 8) for cp in (32, 64)]
    for (H, dk, cp), text in zip(shapes, m.groups()):
        n = int(text.replace(",", ""))
        assert n == _bwd_h4_smem(cp, dk, H) and n <= 233_472 // 2 - 1024, (H, dk, cp)


def test_cpu_streamed_backward_at_the_example_widths_counts_the_torch_route(rng):
    """CPU tensors at the example's widths run ``ipa_attention_backward``,
    though CUDA tensors of these widths take "bwd_h4s": the pass counts under
    "torch", and ``pa`` gets its gradient shaped as itself."""
    a, ct = _inputs(rng, 2, 8, 8, 2)
    leaves = [None if t is None else t.requires_grad_(n != "bias")
              for n, t in zip(NAMES, _torch_args(a, "float32", True))]
    before, calls = dict(k1.backward_calls_by_route), k1.backward_calls
    out = k1.ipa_attention(*leaves, **KW)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, ct)).backward()
    assert k1.backward_calls == calls + 1
    assert k1.backward_calls_by_route == {**before, "torch": before["torch"] + 1}
    assert leaves[9].grad.shape == leaves[9].shape and torch.isfinite(leaves[9].grad).all()
