"""K1's backward at the PPFT control net's widths the kernel's way:
``ipa_attention_backward_h4_tiled`` against JAX ``_fused_backward_chunked``
(``has_pa=False``) and against ``ipa_attention_backward``.

``ipa_attention_backward_h4_tiled`` is the algebra of the backward kernel
``se3diff_torch/csrc/ipa_attention_bwd_h4.cu`` (route "bwd_h4": f32, 4 heads
of 16, the pair bias computed from ``w_pb``, Cp <= 64): the logit's terms
outside x2d and the value terms first; one sweep over key tiles of 16 adding
the x2d products and carrying the row statistics, D's sum and the x2d
aggregates U = sum p x2d and V = sum p dphat x2d online; d_w_pb from (V - D
U) / sum, added by row blocks of 8; a second sweep on the kept logits and
dphat; explicit point differences; the x2d products with the operands the
kernel's tensor cores see (3xTF32, both terms truncated). The kernel runs on
the card only; this holds its arithmetic here on the same numpy inputs, in
the kernel layout.

Tolerance, tests/test_torch_ipa_backward_kernel.py's f32 one: 1e-4 absolute
and 1e-3 relative (same function, sums in another order). JAX's gradient of
the column bias is compared with nothing: the port returns None for the
mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import ipa_attention as k1
from se3diff_tpu.ops.pallas_ipa import NEG_INF, _fused_backward_chunked

H, DK = 4, 16
KW = dict(scalar_w=1.0 / np.sqrt(3 * DK), pair_w=1.0 / np.sqrt(3))
NAMES = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa", "w_pb")
# JAX's operands: w_pb 8th (index 7), before w_pv; no pa.
JAX_ORDER = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pb", "w_pv", "bias")


def _inputs(rng, B, Lq, Lk, masked_cols=0, cp=32):
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
    ct = (g(B, H, Lq, DK), g(B, H, Lq, 24), g(B, H, Lq, DK))
    return a, ct


def _torch(a, ct):
    ins = [None if n == "pa" else torch.from_numpy(a[n]) for n in NAMES]
    return ins, tuple(torch.from_numpy(c) for c in ct)


def _jax(a, ct):
    return [jnp.asarray(a[n]) for n in JAX_ORDER], tuple(jnp.asarray(c) for c in ct)


def _assert_close(name, got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=1e-4, rtol=1e-3,
                               err_msg=name)


# (B, Lq, Lk, masked columns, Cp): square and prime L (ragged key tiles of
# 4), masked columns, Cp at 32 and at the route's largest 64 (and one not a
# multiple of 32), a row slab with Lq != Lk.
CASES = [
    (2, 8, 8, 0, 32),
    (2, 13, 13, 3, 32),
    (2, 19, 19, 2, 64),
    (2, 11, 20, 4, 32),
    (2, 16, 16, 0, 64),
    (1, 17, 17, 5, 36),
]


@pytest.mark.parametrize("B,Lq,Lk,masked,cp", CASES)
def test_h4_tiled_backward_matches_jax_and_the_chunked_port(rng, B, Lq, Lk, masked, cp):
    a, ct = _inputs(rng, B, Lq, Lk, masked, cp)
    ins, cts = _torch(a, ct)
    assert k1.backward_route(torch.float32, H, DK, cp, False) == "bwd_h4"
    got = k1.ipa_attention_backward_h4_tiled(ins, cts, **KW)
    port = k1.ipa_attention_backward(ins, cts, **KW)
    arrs, jct = _jax(a, ct)
    want = _fused_backward_chunked(arrs, jct, **KW)  # ten: d_bias last
    assert len(got) == len(port) == 11
    assert got[NAMES.index("bias")] is None and got[NAMES.index("pa")] is None
    for name, g, p, other in zip(NAMES, got, ins, port):
        if name in ("bias", "pa"):
            continue
        assert g.dtype == p.dtype and g.shape == p.shape, name
        _assert_close(name, g, want[JAX_ORDER.index(name)].astype(jnp.float32))
        _assert_close(name, g, other)


@pytest.mark.parametrize("tile,rows", [(1, 1), (4, 3), (4, 56), (64, 8), (16, 8), (16, 56)])
def test_h4_sweep_is_independent_of_the_tile_and_the_row_blocks(rng, tile, rows):
    """The online statistics and aggregates over any key tile, and d_w_pb's
    partials over any row block, give the same gradients to rounding (the
    kernel's tiles of 16 and row blocks of 8 among them)."""
    a, ct = _inputs(rng, 2, 13, 37, masked_cols=4)
    ins, cts = _torch(a, ct)
    one = k1.ipa_attention_backward_h4_tiled(ins, cts, tile=64, rows=56, **KW)
    many = k1.ipa_attention_backward_h4_tiled(ins, cts, tile=tile, rows=rows, **KW)
    for name, x, y in zip(NAMES, one, many):
        if x is not None:
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5, msg=name)


def test_h4_coincident_points_give_zero_point_subgradients(rng):
    """Where every query and key point coincides (d2 = 0) the distances'
    subgradient is zero, and every other gradient stays finite and equal to
    the chunked port's."""
    a, ct = _inputs(rng, 1, 9, 14, masked_cols=2)
    a = dict(a, q_p=np.zeros_like(a["q_p"]), k_p=np.zeros_like(a["k_p"]))
    ins, cts = _torch(a, ct)
    got = k1.ipa_attention_backward_h4_tiled(ins, cts, **KW)
    port = k1.ipa_attention_backward(ins, cts, **KW)
    assert torch.count_nonzero(got[3]) == 0 and torch.count_nonzero(got[4]) == 0
    for name, g, other in zip(NAMES, got, port):
        if g is not None:
            assert torch.isfinite(g).all(), name
            _assert_close(name, g, other)


@pytest.mark.parametrize("B,Lq,Lk,masked,cp", [(2, 13, 13, 3, 32), (2, 19, 19, 2, 64)])
def test_h4_tensor_core_splits_keep_f32_accuracy(rng, B, Lq, Lk, masked, cp):
    """The x2d products with the operands the kernel's tensor cores see
    (each f32 operand as a truncated TF32 big term and a truncated TF32 rest,
    the small x small product dropped) against the same algebra in f32: each
    gradient within 1e-5 of its largest entry, and the split does change
    them (the products are not f32 ones)."""
    a, ct = _inputs(rng, B, Lq, Lk, masked, cp)
    ins, cts = _torch(a, ct)
    split = k1.ipa_attention_backward_h4_tiled(ins, cts, **KW)
    exact = k1.ipa_attention_backward_h4_tiled(ins, cts, tf32=False, **KW)
    for name, x, y in zip(NAMES, split, exact):
        if x is None:
            continue
        assert not torch.equal(x, y), name
        err = (x - y).abs().max().item()
        assert err <= 1e-5 * y.abs().max().item(), (name, err)
