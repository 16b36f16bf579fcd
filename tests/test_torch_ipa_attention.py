"""IPA attention core: the port's plain version against the JAX kernel.

``ipa_attention`` runs its plain version on CPU tensors; that version is
held against the Pallas kernel in interpret mode and against its jnp twin
``_fused_semantics_jnp``, on the same numpy inputs in the kernel layout
(mirrors tests/test_pallas_ipa.py). The JAX kernel needs tile-multiple
shapes, so ragged cases pad its operands (NEG_INF columns, discarded rows)
while the port takes the ragged shapes as they are.

Tolerances: f32 2e-5 (the JAX kernel's own oracle tolerance; sums run in
another order). bf16 3e-2 on outputs of unit scale: the scalar and pair
outputs are rounded to bf16 (2^-8 relative) and the kernel rounds the
unnormalised softmax weights where the plain versions round normalised ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import ipa_attention as k1
from se3diff_tpu.ops.pallas_ipa import NEG_INF, _fused_semantics_jnp, fused_ipa_attention

H, DK, CP = 4, 8, 32
SCALAR_W = 1.0 / np.sqrt(3 * DK)
PAIR_W = 1.0 / np.sqrt(3)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(rng, B, Lq, Lk, masked_cols=0):
    """Kernel-layout operands as float32 numpy arrays (w_pb included)."""
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    if masked_cols:
        bias[:, -masked_cols:] = NEG_INF
    return dict(
        q_s=g(B, H, Lq, DK), k_s=g(B, H, Lk, DK), v_s=g(B, H, Lk, DK),
        q_p=g(B, 3, H * 4, Lq, scale=0.6), k_p=g(B, 3, H * 4, Lk, scale=0.6),
        v_p=g(B, H, Lk, 24), x2d=g(B, Lq, Lk, CP, scale=0.5),
        w_pb=g(CP, H, scale=0.3), w_pv=g(H, CP, DK, scale=0.3), bias=bias,
    )


def _pa(a):
    return np.einsum("bijp,ph->bhij", a["x2d"], a["w_pb"]).astype(np.float32)


def _port(a, pa, dtype):
    t = lambda name: torch.from_numpy(a[name])
    md = getattr(torch, dtype)
    out = k1.ipa_attention(
        t("q_s").to(md), t("k_s").to(md), t("v_s").to(md), t("q_p"), t("k_p"), t("v_p"),
        t("x2d").to(md), t("w_pv").to(md), t("bias"), torch.from_numpy(pa).to(md),
        scalar_w=SCALAR_W, pair_w=PAIR_W,
    )
    return [o.float().numpy() for o in out]


def _pad(a, pa, Lq, Lk):
    """Pad JAX operands to (Lq, Lk): zero rows/columns, NEG_INF bias columns."""
    def pad(x, axis, n, value=0.0):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, n - x.shape[axis])
        return np.pad(x, widths, constant_values=value)

    out = dict(a)
    for k in ("q_s",):
        out[k] = pad(a[k], 2, Lq)
    for k in ("k_s", "v_s", "v_p"):
        out[k] = pad(a[k], 2, Lk)
    out["q_p"], out["k_p"] = pad(a["q_p"], 3, Lq), pad(a["k_p"], 3, Lk)
    out["x2d"] = pad(pad(a["x2d"], 1, Lq), 2, Lk)
    out["bias"] = pad(a["bias"], 1, Lk, NEG_INF)
    return out, pad(pad(pa, 2, Lq), 3, Lk)


def _jax_args(a, dtype):
    md = getattr(jnp, dtype)
    cast = lambda k: jnp.asarray(a[k]).astype(md) if k in ("q_s", "k_s", "v_s", "x2d", "w_pv") else jnp.asarray(a[k])
    return [cast(k) for k in ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pb", "w_pv", "bias")]


def _check(got, want, dtype, rows):
    for g, w, name in zip(got, want, ("scalar", "point", "pair")):
        np.testing.assert_allclose(
            g, np.asarray(w, np.float32)[:, :, :rows], atol=TOL[dtype], rtol=TOL[dtype], err_msg=name
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Lq,Lk,pad_to,tile,masked", [
    (2, 16, 16, 16, 8, 0),    # square, two tiles each way
    (1, 16, 16, 16, 8, 5),    # masked columns
    (1, 10, 10, 16, 8, 3),    # ragged L, padded for the JAX kernel
    (2, 12, 20, 24, 8, 0),    # rectangular ragged (rows != columns)
])
def test_plain_matches_pallas_kernel(rng, dtype, B, Lq, Lk, pad_to, tile, masked):
    a = _inputs(rng, B, Lq, Lk, masked)
    pa = _pa(a)
    got = _port(a, pa, dtype)
    ja, jpa = _pad(a, pa, pad_to, max(pad_to, Lk + (-Lk % tile)))
    args = _jax_args(ja, dtype)
    kernel = fused_ipa_attention(
        *args, jnp.asarray(jpa).astype(args[0].dtype), scalar_w=SCALAR_W, pair_w=PAIR_W,
        ti=tile, tj=tile, interpret=True,
    )
    _check(got, kernel, dtype, Lq)
    # One batch element per call: XLA's CPU backend has no batched
    # bf16 x bf16 -> f32 dot.
    jpa = jnp.asarray(jpa).astype(args[0].dtype)
    per_b = [
        _fused_semantics_jnp(
            *[x if i in (7, 8) else x[b:b + 1] for i, x in enumerate(args)], jpa[b:b + 1],
            scalar_w=SCALAR_W, pair_w=PAIR_W,
        )
        for b in range(B)
    ]
    _check(got, [np.concatenate([np.asarray(o[k], np.float32) for o in per_b]) for k in range(3)], dtype, Lq)


def test_streamed_pair_bias_equals_in_kernel_projection(rng):
    """The port streams pa = x2d @ w_pb; the JAX kernel without pa computes
    that product in-kernel. Same results in f32."""
    a = _inputs(rng, 1, 16, 16)
    got = _port(a, _pa(a), "float32")
    want = fused_ipa_attention(
        *_jax_args(a, "float32"), scalar_w=SCALAR_W, pair_w=PAIR_W, ti=8, tj=8, interpret=True
    )
    _check(got, want, "float32", 16)


def test_masked_columns_do_not_contribute(rng):
    """Masking the last columns equals dropping them."""
    a = _inputs(rng, 1, 12, 12, masked_cols=4)
    full = _port(a, _pa(a), "float32")
    cut = {k: v for k, v in a.items()}
    for k in ("k_s", "v_s", "v_p"):
        cut[k] = np.ascontiguousarray(a[k][:, :, :8])
    cut["k_p"] = np.ascontiguousarray(a["k_p"][..., :8])
    cut["x2d"] = np.ascontiguousarray(a["x2d"][:, :, :8])
    cut["bias"] = np.zeros((1, 8), np.float32)
    short = _port(cut, _pa(cut), "float32")
    for f, s in zip(full, short):
        np.testing.assert_allclose(f, s, atol=2e-6)


def test_cpu_tensors_take_the_plain_version(rng):
    a = _inputs(rng, 1, 8, 8)
    before = k1.launches
    _port(a, _pa(a), "float32")
    assert k1.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,cp", [(8, 64), (16, 64), (16, 256)], ids=["8", "16", "16-cp256"])
def test_plain_matches_jnp_twin_at_more_card_head_counts(rng, dtype, heads, cp):
    """8 and 16 heads of width 16 (the card takes 4, 8, 16 and 32), and 16
    heads at the full pair width 256 (a tensor-parallel rank of the
    bioemu-v1.0 score model at ``--mesh model=2``): the plain version
    against ``_fused_semantics_jnp``, ragged with masked columns, rows !=
    columns."""
    B, Lq, Lk, dk = 2, 11, 13, 16
    wide = (64 / cp) ** 0.5  # weights over Cp channels at the same output scale
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    bias[:, -3:] = NEG_INF
    a = dict(
        q_s=g(B, heads, Lq, dk), k_s=g(B, heads, Lk, dk), v_s=g(B, heads, Lk, dk),
        q_p=g(B, 3, heads * 4, Lq, scale=0.6), k_p=g(B, 3, heads * 4, Lk, scale=0.6),
        v_p=g(B, heads, Lk, 24), x2d=g(B, Lq, Lk, cp, scale=0.5),
        w_pb=g(cp, heads, scale=0.3 * wide), w_pv=g(heads, cp, dk, scale=0.3 * wide), bias=bias,
    )
    pa = _pa(a)
    md = getattr(torch, dtype)
    t = lambda name: torch.from_numpy(a[name])
    scalar_w = 1.0 / np.sqrt(3 * dk)
    got = k1.ipa_attention(
        t("q_s").to(md), t("k_s").to(md), t("v_s").to(md), t("q_p"), t("k_p"), t("v_p"),
        t("x2d").to(md), t("w_pv").to(md), t("bias"), torch.from_numpy(pa).to(md),
        scalar_w=scalar_w, pair_w=PAIR_W,
    )
    args = _jax_args(a, dtype)
    jpa = jnp.asarray(pa).astype(args[0].dtype)
    per_b = [
        _fused_semantics_jnp(
            *[x if i in (7, 8) else x[b:b + 1] for i, x in enumerate(args)], jpa[b:b + 1],
            scalar_w=scalar_w, pair_w=PAIR_W,
        )
        for b in range(B)
    ]
    want = [np.concatenate([np.asarray(o[k], np.float32) for o in per_b]) for k in range(3)]
    _check([o.float().numpy() for o in got], want, dtype, Lq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_at_a_model_4_rank(rng, dtype):
    """8 heads of width 16 at the full pair width 256: a tensor-parallel
    rank of the bioemu-v1.0 score model at ``--mesh model=4``, whose CUDA
    operands take the 8-head designs ("tc8", "tc8_f32"). The plain version
    against the Pallas kernel in interpret mode, ragged (rows != columns,
    padded for the JAX kernel) with masked columns."""
    heads, dk, cp = 8, 16, 256
    B, Lq, Lk, pad_q, pad_k, tile = 1, 11, 13, 16, 16, 8
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    bias[:, -3:] = NEG_INF
    a = dict(
        q_s=g(B, heads, Lq, dk), k_s=g(B, heads, Lk, dk), v_s=g(B, heads, Lk, dk),
        q_p=g(B, 3, heads * 4, Lq, scale=0.6), k_p=g(B, 3, heads * 4, Lk, scale=0.6),
        v_p=g(B, heads, Lk, 24), x2d=g(B, Lq, Lk, cp, scale=0.5),
        w_pb=g(cp, heads, scale=0.15), w_pv=g(heads, cp, dk, scale=0.15), bias=bias,
    )
    pa = _pa(a)
    md = getattr(torch, dtype)
    t = lambda name: torch.from_numpy(a[name])
    scalar_w = 1.0 / np.sqrt(3 * dk)
    got = k1.ipa_attention(
        t("q_s").to(md), t("k_s").to(md), t("v_s").to(md), t("q_p"), t("k_p"), t("v_p"),
        t("x2d").to(md), t("w_pv").to(md), t("bias"), torch.from_numpy(pa).to(md),
        scalar_w=scalar_w, pair_w=PAIR_W,
    )
    ja, jpa = _pad(a, pa, pad_q, pad_k)
    args = _jax_args(ja, dtype)
    kernel = fused_ipa_attention(
        *args, jnp.asarray(jpa).astype(args[0].dtype), scalar_w=scalar_w, pair_w=PAIR_W,
        ti=tile, tj=tile, interpret=True,
    )
    _check([o.float().numpy() for o in got], kernel, dtype, Lq)
