"""K1's backward: ``ipa_attention_backward`` against JAX ``_fused_backward_chunked``.

The port's IPA attention core is a ``torch.autograd.Function`` whose
backward recomputes the attention a chunk of query rows at a time, a port
of the JAX package's chunked backward for the streamed pair bias. Both run
here on the same numpy inputs in the kernel layout (mirrors
tests/test_pallas_ipa.py::TestChunkedBackward).

Tolerances:
* f32: 1e-4 absolute and 1e-3 relative. Same arithmetic, sums in another
  order.
* bf16: 1e-2 x max(1, max|JAX|). Both sides compute in f32 from the same bf16
  values, then round the gradients of bf16 operands to bf16 (2^-8
  relative): a sum that differs in its last f32 bits may round to the
  neighbouring bf16 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import ipa_attention as k1
from se3diff_tpu.ops.pallas_ipa import NEG_INF, _fused_backward_chunked

H, DK, CP = 4, 8, 32
KW = dict(scalar_w=1.0 / np.sqrt(3 * DK), pair_w=1.0 / np.sqrt(3))
NAMES = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa")
MODEL_DTYPE = ("q_s", "k_s", "v_s", "x2d", "w_pv", "pa")
# Index of each port operand among the JAX function's eleven (w_pb is 7th).
JAX_INDEX = dict(zip(NAMES, (0, 1, 2, 3, 4, 5, 6, 8, 9, 10)))


def _inputs(rng, B, Lq, Lk, masked_cols=0):
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    if masked_cols:
        bias[:, -masked_cols:] = NEG_INF
    a = dict(
        q_s=g(B, H, Lq, DK), k_s=g(B, H, Lk, DK), v_s=g(B, H, Lk, DK),
        q_p=g(B, 3, H * 4, Lq, scale=0.6), k_p=g(B, 3, H * 4, Lk, scale=0.6),
        v_p=g(B, H, Lk, 24), x2d=g(B, Lq, Lk, CP, scale=0.5),
        w_pv=g(H, CP, DK, scale=0.3), bias=bias, w_pb=g(CP, H, scale=0.3),
    )
    a["pa"] = np.einsum("bijp,ph->bhij", a["x2d"], a["w_pb"]).astype(np.float32)
    ct = (g(B, H, Lq, DK), g(B, H, Lq, 24), g(B, H, Lq, DK))
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


@pytest.mark.parametrize("dtype,B,Lq,Lk,masked,row_chunk", [
    ("float32", 2, 16, 16, 0, 128),    # one chunk
    ("float32", 1, 12, 20, 5, 4),      # Lq != Lk, masked columns, three chunks
    ("bfloat16", 2, 16, 16, 3, 8),     # two chunks
    ("bfloat16", 1, 10, 24, 4, 3),     # ragged last chunk (JAX: chunks of 2)
])
def test_backward_matches_jax_chunked(rng, dtype, B, Lq, Lk, masked, row_chunk):
    a, ct = _inputs(rng, B, Lq, Lk, masked)
    ins, cts = _torch(a, ct, dtype)
    got = k1.ipa_attention_backward(ins, cts, row_chunk=row_chunk, **KW)
    arrs, jct = _jax(a, ct, dtype)
    want = _fused_backward_chunked(arrs, jct, row_chunk=row_chunk, **KW)
    assert got[NAMES.index("bias")] is None
    for name, g, p in zip(NAMES, got, ins):
        if name == "bias":
            continue
        w = np.asarray(want[JAX_INDEX[name]].astype(jnp.float32))
        assert g.dtype == p.dtype and g.shape == p.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-3, err_msg=name)
        else:
            err = np.abs(g.float().numpy() - w).max()
            assert err <= 1e-2 * max(1.0, np.abs(w).max()), (name, err)


def test_several_chunks_equal_one_chunk(rng):
    a, ct = _inputs(rng, 2, 13, 11, masked_cols=2)
    ins, cts = _torch(a, ct, "float32")
    one = k1.ipa_attention_backward(ins, cts, row_chunk=128, **KW)
    many = k1.ipa_attention_backward(ins, cts, row_chunk=4, **KW)
    for name, x, y in zip(NAMES, one, many):
        if x is not None:
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0, msg=name)


def test_coincident_points_give_finite_zero_subgradients(rng):
    """Exactly coincident points (d2 = 0) contribute nothing to the point
    gradients, and bf16-coincident pairs stay finite and bounded (the JAX
    test's 1e3 bound), equal to JAX's."""
    a, ct = _inputs(rng, 1, 16, 16, masked_cols=3)
    # Every point at the origin: d2 is 0 for every pair.
    z = dict(a, q_p=np.zeros_like(a["q_p"]), k_p=np.zeros_like(a["k_p"]))
    ins, cts = _torch(z, ct, "float32")
    got = k1.ipa_attention_backward(ins, cts, **KW)
    assert torch.count_nonzero(got[3]) == 0 and torch.count_nonzero(got[4]) == 0
    # Two point-heads coincide row i with column i, in bf16.
    a["k_p"][:, :, :2, :] = a["q_p"][:, :, :2, :]
    ins, cts = _torch(a, ct, "bfloat16")
    got = k1.ipa_attention_backward(ins, cts, row_chunk=8, **KW)
    arrs, jct = _jax(a, ct, "bfloat16")
    want = _fused_backward_chunked(arrs, jct, row_chunk=8, **KW)
    for name in ("q_s", "k_s", "v_s", "q_p", "k_p"):
        g = got[NAMES.index(name)].float()
        assert torch.isfinite(g).all() and g.abs().max() < 1e3, name
        w = np.asarray(want[JAX_INDEX[name]].astype(jnp.float32))
        assert np.abs(g.numpy() - w).max() <= 1e-2 * max(1.0, np.abs(w).max()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_carries_history_and_matches_autograd_of_plain(rng, dtype):
    """Outputs of ``ipa_attention`` carry a ``grad_fn``, and its gradients
    equal autograd through ``ipa_attention_plain`` on the same values in
    f32, each within its own largest entry times 1e-5 (f32), plus 2^-8 in
    bf16 (one rounding of the f32 gradient to bf16's 8 significant bits)."""
    a, ct = _inputs(rng, 2, 9, 12, masked_cols=3)
    ins, cts = _torch(a, ct, dtype)
    leaves = [t.clone().requires_grad_(n != "bias") for n, t in zip(NAMES, ins)]
    outs = k1.ipa_attention(*leaves, **KW)
    assert all(o.grad_fn is not None for o in outs)
    diff = [t for n, t in zip(NAMES, leaves) if n != "bias"]
    got = torch.autograd.grad(outs, diff, cts)
    ref = [t.detach().float().requires_grad_(n != "bias") for n, t in zip(NAMES, ins)]
    want = torch.autograd.grad(
        k1.ipa_attention_plain(*ref, **KW), [t for n, t in zip(NAMES, ref) if n != "bias"],
        [c.float() for c in cts])
    tol = 1e-5 if dtype == "float32" else 2.0**-8 + 1e-5
    for name, g, p, w in zip([n for n in NAMES if n != "bias"], got, diff, want):
        assert g.dtype == p.dtype, name
        err = (g.float() - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err)


def test_backward_launches_no_kernel(rng):
    a, ct = _inputs(rng, 1, 8, 8)
    ins, cts = _torch(a, ct, "float32")
    leaves = [t.requires_grad_(n != "bias") for n, t in zip(NAMES, ins)]
    before, backwards = k1.launches, k1.backward_calls
    out = k1.ipa_attention(*leaves, **KW)
    sum((o * c).sum() for o, c in zip(out, cts)).backward()
    assert k1.launches == before  # CPU tensors: plain forward, no launch
    assert k1.backward_calls == backwards + 1
    assert leaves[0].grad is not None and leaves[NAMES.index("bias")].grad is None
