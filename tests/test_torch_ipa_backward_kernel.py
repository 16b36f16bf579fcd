"""K1's backward the kernel's way: ``ipa_attention_backward_tiled`` against
JAX ``_fused_backward_chunked`` and against ``ipa_attention_backward``.

``ipa_attention_backward_tiled`` is the algebra of the backward kernels
(``se3diff_torch/csrc/ipa_attention_bwd_tc.cu`` at 32 heads,
``ipa_attention_bwd_tc16.cu`` at 16, ``ipa_attention_bwd_tc8.cu`` at 8): a
statistics sweep over key tiles of 16, D from the row aggregate wx2d, the
column sums from the saved statistics and ds, explicit point differences,
and the tensor cores' operand roundings (bf16: f32 operands as two bf16
terms, x2d exact; f32: 3xTF32, split by truncation at 32, 16 and 8 heads). The kernel runs on the card only; this
holds its arithmetic here on the same numpy inputs, in the kernel layout,
with the streamed pair bias.

Tolerances, tests/test_torch_ipa_backward.py's:
* f32: 1e-4 absolute and 1e-3 relative. Same function, sums in another
  order, and 3xTF32 products (about 2^-21 of each).
* bf16: 1e-2 x max(1, max|reference|). Both sides compute in f32 from the
  same bf16 values and round the bf16 gradients once; the kernel's f32
  operands carry 16 significant bits into the tensor cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import ipa_attention as k1
from se3diff_tpu.ops.pallas_ipa import NEG_INF, _fused_backward_chunked

NAMES = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa")
MODEL_DTYPE = ("q_s", "k_s", "v_s", "x2d", "w_pv", "pa")
# Index of each port operand among the JAX function's eleven (w_pb is 7th).
JAX_INDEX = dict(zip(NAMES, (0, 1, 2, 3, 4, 5, 6, 8, 9, 10)))


def _kw(dk):
    return dict(scalar_w=1.0 / np.sqrt(3 * dk), pair_w=1.0 / np.sqrt(3))


def _inputs(rng, B, Lq, Lk, masked_cols=0, H=4, dk=8, cp=32):
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    if masked_cols:
        bias[:, -masked_cols:] = NEG_INF
    a = dict(
        q_s=g(B, H, Lq, dk), k_s=g(B, H, Lk, dk), v_s=g(B, H, Lk, dk),
        q_p=g(B, 3, H * 4, Lq, scale=0.6), k_p=g(B, 3, H * 4, Lk, scale=0.6),
        v_p=g(B, H, Lk, 24), x2d=g(B, Lq, Lk, cp, scale=0.5),
        w_pv=g(H, cp, dk, scale=0.3), bias=bias, w_pb=g(cp, H, scale=0.3),
    )
    a["pa"] = np.einsum("bijp,ph->bhij", a["x2d"], a["w_pb"]).astype(np.float32)
    ct = (g(B, H, Lq, dk), g(B, H, Lq, 24), g(B, H, Lq, dk))
    return a, ct


def _torch(a, ct, dtype):
    md = getattr(torch, dtype)
    ins = [torch.from_numpy(a[n]).to(md if n in MODEL_DTYPE else torch.float32) for n in NAMES]
    cts = (torch.from_numpy(ct[0]).to(md), torch.from_numpy(ct[1]), torch.from_numpy(ct[2]).to(md))
    return ins, cts


def _jax(a, ct, dtype):
    md = getattr(jnp, dtype)
    arrs = [
        jnp.asarray(a[n]).astype(md if n in MODEL_DTYPE else jnp.float32)
        for n in ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pb", "w_pv", "bias", "pa")
    ]
    cts = (jnp.asarray(ct[0]).astype(md), jnp.asarray(ct[1]), jnp.asarray(ct[2]).astype(md))
    return arrs, cts


def _assert_close(name, got, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-4, rtol=1e-3, err_msg=name)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-2 * max(1.0, np.abs(want).max()), (name, err)


# (dtype, B, Lq, Lk, masked columns, heads, head width, Cp): Lq != Lk (a row
# slab), key tiles ragged at 16 (Lk = 20, 37, 24), masked columns, and the
# kernels' own widths (Cp = 64 at 32 heads of 16, ipa_attention_bwd_tc.cu,
# and at a tensor-parallel rank's 16, ipa_attention_bwd_tc16.cu, and 8,
# ipa_attention_bwd_tc8.cu). At 32, 16 and 8 heads also an odd row count
# (the last row block, of two rows at 32 and 16 heads and of four at 8, one
# row full) with Lk = 33 and 42, ragged at a lane's four columns of a tile,
# at the smallest and a middle Cp.
CASES = [
    ("float32", 2, 16, 16, 0, 4, 8, 32),
    ("float32", 1, 12, 37, 5, 4, 8, 32),
    ("bfloat16", 2, 16, 20, 3, 4, 8, 32),
    ("bfloat16", 1, 10, 24, 4, 4, 8, 32),
    ("float32", 1, 7, 19, 2, 32, 16, 64),
    ("bfloat16", 1, 7, 19, 2, 32, 16, 64),
    ("float32", 2, 5, 33, 1, 32, 16, 32),
    ("bfloat16", 1, 3, 42, 6, 32, 16, 96),
    ("float32", 2, 9, 37, 5, 16, 16, 64),
    ("bfloat16", 1, 7, 19, 2, 16, 16, 64),
    ("float32", 2, 9, 37, 5, 8, 16, 64),
    ("bfloat16", 1, 7, 19, 2, 8, 16, 64),
    ("float32", 2, 5, 33, 1, 16, 16, 32),
    ("bfloat16", 1, 3, 42, 6, 16, 16, 96),
    ("float32", 2, 5, 33, 1, 8, 16, 32),
    ("bfloat16", 1, 3, 42, 6, 8, 16, 96),
]


@pytest.mark.parametrize("dtype,B,Lq,Lk,masked,H,dk,cp", CASES)
def test_tiled_backward_matches_jax_and_the_chunked_port(rng, dtype, B, Lq, Lk, masked, H, dk, cp):
    a, ct = _inputs(rng, B, Lq, Lk, masked, H, dk, cp)
    ins, cts = _torch(a, ct, dtype)
    got = k1.ipa_attention_backward_tiled(ins, cts, **_kw(dk))
    port = k1.ipa_attention_backward(ins, cts, **_kw(dk))
    arrs, jct = _jax(a, ct, dtype)
    want = _fused_backward_chunked(arrs, jct, **_kw(dk))
    assert got[NAMES.index("bias")] is None
    for name, g, p, other in zip(NAMES, got, ins, port):
        if name == "bias":
            continue
        assert g.dtype == p.dtype and g.shape == p.shape, name
        _assert_close(name, g, want[JAX_INDEX[name]].astype(jnp.float32), dtype)
        _assert_close(name, g, other.float(), dtype)


@pytest.mark.parametrize("tile", [1, 5, 16, 64])
def test_statistics_sweep_is_independent_of_the_tile(rng, tile):
    """The online statistics over any key tile give the softmax's weights:
    the gradients at tile 1, 5, 16 and one tile for all keys agree to
    rounding."""
    a, ct = _inputs(rng, 2, 9, 37, masked_cols=4)
    ins, cts = _torch(a, ct, "float32")
    one = k1.ipa_attention_backward_tiled(ins, cts, tile=64, **_kw(8))
    many = k1.ipa_attention_backward_tiled(ins, cts, tile=tile, **_kw(8))
    for name, x, y in zip(NAMES, one, many):
        if x is not None:
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coincident_points_give_zero_point_subgradients(rng, dtype):
    """Where a query and a key point coincide (d2 = 0) the distance's
    subgradient is zero: every point at the origin gives zero point
    gradients, and pairs made coincident in two point-heads give finite
    gradients equal to JAX's. JAX forms d2 as q2 + k2 - 2 q.k, which leaves
    a rounding residue (some 1e-7) at a coincident pair; its square root
    (some 3e-4) enters JAX's logits, where the kernel's explicit
    differences give d2 = 0 and a distance of 1e-12. So in this
    configuration every gradient is held at 1e-2 x max(1, max|JAX|), in both
    dtypes (f32 differs by up to 3e-4 in d_w_pv and 7.8e-4 in d_k_p)."""
    a, ct = _inputs(rng, 1, 16, 21, masked_cols=3)
    z = dict(a, q_p=np.zeros_like(a["q_p"]), k_p=np.zeros_like(a["k_p"]))
    ins, cts = _torch(z, ct, dtype)
    got = k1.ipa_attention_backward_tiled(ins, cts, **_kw(8))
    assert torch.count_nonzero(got[3]) == 0 and torch.count_nonzero(got[4]) == 0
    a["k_p"][:, :, :2, :16] = a["q_p"][:, :, :2, :]
    ins, cts = _torch(a, ct, dtype)
    got = k1.ipa_attention_backward_tiled(ins, cts, **_kw(8))
    arrs, jct = _jax(a, ct, dtype)
    want = _fused_backward_chunked(arrs, jct, **_kw(8))
    for name in NAMES:
        if name == "bias":
            continue
        g = got[NAMES.index(name)]
        assert torch.isfinite(g.float()).all(), name
        _assert_close(name, g, want[JAX_INDEX[name]].astype(jnp.float32), "bfloat16")


def test_operand_terms_carry_sixteen_bits():
    """The kernel's f32 operands on the tensor cores: two bf16 terms keep
    x to 2^-16 of it, two TF32 terms to 2^-21; one TF32 rounding is to
    nearest with ties away from zero."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = k1._terms(x, torch.bfloat16)
    assert ((hi + lo - x).abs() <= 2.0**-16 * x.abs()).all()
    big, small = k1._terms(x, torch.float32)
    assert ((big + small - x).abs() <= 2.0**-21 * x.abs()).all()
    ties = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12], dtype=torch.float32)
    assert k1._tf32(ties).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]


def test_point_gradients_hold_against_f64_where_f32_plain_autograd_loses_them(rng):
    """The kernels' algebra takes point distances from explicit differences:
    at a near-coincident query and key point (1e-3 apart, 16 heads of 16,
    Cp = 64), its f32 point gradients stay within 1e-5 of the largest of
    autograd through the plain version in f64, while autograd of the plain
    version in f32, whose d2 = q2 + k2 - 2 q.k cancels there, is off by ten
    times more: why the card's gradient checks hold the kernel routes
    against the plain version, and the PyTorch backward, in f64 (which the
    PyTorch backward on f64 operands matches to 1e-10)."""
    a, ct = _inputs(rng, 2, 9, 37, 5, H=16, dk=16, cp=64)
    a["k_p"][0, :, 0, 3] = a["q_p"][0, :, 0, 2] + np.float32(1e-3 / np.sqrt(3))
    ins, cts = _torch(a, ct, "float32")
    got = k1.ipa_attention_backward_tiled(ins, cts, **_kw(16))

    def plain_grads(dtype):
        leaves = [t.to(dtype).requires_grad_(n != "bias") for n, t in zip(NAMES, ins)]
        outs = k1.ipa_attention_plain(*leaves, **_kw(16))
        return dict(zip(("q_p", "k_p"), torch.autograd.grad(
            outs, [leaves[NAMES.index("q_p")], leaves[NAMES.index("k_p")]],
            [c.to(dtype) for c in cts])))

    truth, f32 = plain_grads(torch.float64), plain_grads(torch.float32)
    chunked64 = k1.ipa_attention_backward([t.double() for t in ins], [c.double() for c in cts],
                                          **_kw(16))
    for name in ("q_p", "k_p"):
        scale = truth[name].abs().max().item()
        err = (got[NAMES.index(name)].double() - truth[name]).abs().max().item() / scale
        err32 = (f32[name].double() - truth[name]).abs().max().item() / scale
        err64 = (chunked64[NAMES.index(name)] - truth[name]).abs().max().item() / scale
        assert err <= 1e-5 and err32 >= 10 * err and err64 <= 1e-10, (name, err, err32, err64)
