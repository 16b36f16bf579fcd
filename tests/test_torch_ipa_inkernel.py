"""The IPA attention core with the pair bias computed in the kernel
(``has_pa=False``: ``pa = x2d @ w_pb``), and the model that runs it.

1. ``ipa_attention`` with ``w_pb`` in place of ``pa`` (its plain version on
   CPU tensors) against the JAX Pallas kernel without ``pa`` in interpret
   mode and against ``_fused_semantics_jnp(pa=None)``, at 2 and 4 heads of
   width 8 (Cp=32), f32 and bf16, masked and ragged, and at 32 heads of
   width 16 with Cp=64 (the widths of the card's "tc_pb" and "tc_pb_f32"
   designs) on the ragged, masked case. Tolerances as tests/test_torch_ipa_attention.py:
   f32 2e-5, bf16 3e-2 (outputs of unit scale rounded to bf16, and the
   kernel rounds unnormalised softmax weights). The jnp twin runs in f32
   only: XLA's CPU backend has no bf16 x bf16 -> f32 dot for its
   ``x2d @ w_pb``.
2. ``ipa_attention_backward`` with ``w_pb`` against JAX
   ``_fused_backward_chunked`` without ``pa`` (f32: 1e-4 absolute, 1e-3
   relative, sums in another order), and the Function's gradients against
   autograd of the plain version (each within 1e-5 of its largest entry).
3. The port's model with ``with_pa=False`` against the flax model's unfused
   path (``use_pallas=False``, no ``pa``) on the same parameters, f32, at
   1e-4 of the output scale (as tests/test_torch_dig.py: point-distance
   epsilons differ, 1e-24 against 1e-12); and against ``with_pa=True`` in
   the port at 1e-5 (the same products, the pair bias summed per layer
   either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.ops import ipa_attention as k1
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.ops.pallas_ipa import (
    NEG_INF,
    _fused_backward_chunked,
    _fused_semantics_jnp,
    fused_ipa_attention,
)

DK, CP = 8, 32
KW = dict(scalar_w=1.0 / np.sqrt(3 * DK), pair_w=1.0 / np.sqrt(3))
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The port's eleven operands; pa is None throughout.
NAMES = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa", "w_pb")
MODEL_DTYPE = ("q_s", "k_s", "v_s", "x2d", "w_pv")
# The JAX function's ten operands (w_pb before w_pv; no pa).
JAX_ORDER = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pb", "w_pv", "bias")


def _inputs(rng, B, Lq, Lk, H, masked_cols=0, dk=DK, cp=CP):
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    if masked_cols:
        bias[:, -masked_cols:] = NEG_INF
    return dict(
        q_s=g(B, H, Lq, dk), k_s=g(B, H, Lk, dk), v_s=g(B, H, Lk, dk),
        q_p=g(B, 3, H * 4, Lq, scale=0.6), k_p=g(B, 3, H * 4, Lk, scale=0.6),
        v_p=g(B, H, Lk, 24), x2d=g(B, Lq, Lk, cp, scale=0.5),
        w_pb=g(cp, H, scale=0.3 * (CP / cp) ** 0.5), w_pv=g(H, cp, dk, scale=0.3), bias=bias,
    )


def _torch(a, dtype):
    md = getattr(torch, dtype)
    return [
        None if n == "pa" else torch.from_numpy(a[n]).to(md if n in MODEL_DTYPE else torch.float32)
        for n in NAMES
    ]


def _jax(a, dtype):
    md = getattr(jnp, dtype)
    return [jnp.asarray(a[n]).astype(md if n in MODEL_DTYPE else jnp.float32) for n in JAX_ORDER]


def _pad(a, Lq, Lk):
    """JAX operands padded to (Lq, Lk): zero rows/columns, NEG_INF bias columns."""
    def pad(x, axis, n, value=0.0):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, n - x.shape[axis])
        return np.pad(x, widths, constant_values=value)

    out = dict(a)
    out["q_s"] = pad(a["q_s"], 2, Lq)
    for k in ("k_s", "v_s", "v_p"):
        out[k] = pad(a[k], 2, Lk)
    out["q_p"], out["k_p"] = pad(a["q_p"], 3, Lq), pad(a["k_p"], 3, Lk)
    out["x2d"] = pad(pad(a["x2d"], 1, Lq), 2, Lk)
    out["bias"] = pad(a["bias"], 1, Lk, NEG_INF)
    return out


def _check(got, want, dtype, rows):
    for g, w, name in zip(got, want, ("scalar", "point", "pair")):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32)[:, :, :rows],
            atol=TOL[dtype], rtol=TOL[dtype], err_msg=name,
        )


def _against_pallas(a, dtype, Lq, pad_to):
    got = k1.ipa_attention(*_torch(a, dtype), **KW)
    args = _jax(_pad(a, pad_to, pad_to), dtype)
    kernel = fused_ipa_attention(*args, None, ti=8, tj=8, interpret=True, **KW)
    _check(got, kernel, dtype, Lq)
    if dtype == "bfloat16":
        return  # XLA's CPU backend has no bf16 x bf16 -> f32 dot for the twin's x2d @ w_pb
    _check(got, _fused_semantics_jnp(*args, None, **KW), dtype, Lq)


@pytest.mark.parametrize("H", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Lq,Lk,pad_to,masked", [
    (2, 16, 16, 16, 0),   # square, two tiles each way
    (1, 16, 16, 16, 5),   # masked columns
    (1, 10, 13, 16, 3),   # ragged rows and columns, padded for the JAX kernel
])
def test_in_kernel_pair_bias_matches_pallas(rng, H, dtype, B, Lq, Lk, pad_to, masked):
    _against_pallas(_inputs(rng, B, Lq, Lk, H, masked), dtype, Lq, pad_to)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_kernel_pair_bias_matches_pallas_at_32_heads(rng, dtype):
    """32 heads at the card's tc_pb widths (head width 16, Cp a multiple of
    32), ragged rows and columns with 3 masked, padded for the JAX kernel."""
    a = _inputs(rng, 1, 10, 13, 32, 3, dk=16, cp=64)
    _against_pallas(a, dtype, 10, 16)


def test_in_kernel_equals_streamed_pair_bias(rng):
    """``w_pb`` in the kernel and ``pa = x2d @ w_pb`` streamed agree in f32."""
    a = _inputs(rng, 2, 9, 11, 4, masked_cols=2)
    ins = _torch(a, "float32")
    got = k1.ipa_attention(*ins, **KW)
    pa = torch.einsum("bijp,ph->bhij", ins[6], ins[10])
    want = k1.ipa_attention(*ins[:9], pa, **KW)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def test_exactly_one_pair_bias(rng):
    ins = _torch(_inputs(rng, 1, 4, 4, 2), "float32")
    pa = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="exactly one"):
        k1.ipa_attention(*ins[:9], pa, ins[10], **KW)
    with pytest.raises(ValueError, match="exactly one"):
        k1.ipa_attention(*ins[:9], **KW)


def test_sp_slabs_of_in_kernel_pair_bias_equal_all_rows(rng):
    """``sp_ipa_attention`` with ``pa=None``: row slabs, concatenated, equal
    all rows (the rows are independent)."""
    a = _inputs(rng, 1, 13, 13, 4, masked_cols=2)
    ins = _torch(a, "float32")
    full = k1.ipa_attention(*ins, **KW)
    outs = []
    for r0, r1 in ((0, 7), (7, 13)):
        slab = list(ins)
        slab[0], slab[3], slab[6] = ins[0][:, :, r0:r1], ins[3][..., r0:r1], ins[6][:, r0:r1]
        outs.append(k1.sp_ipa_attention((r0, r1), *slab, **KW))
    for i in range(3):
        torch.testing.assert_close(torch.cat([o[i] for o in outs], dim=2), full[i], atol=1e-6, rtol=0)


@pytest.mark.parametrize("B,Lq,Lk,masked,row_chunk,H", [
    (2, 16, 16, 0, 128, 4),   # one chunk
    (1, 12, 20, 5, 4, 2),     # Lq != Lk, masked columns, three chunks
])
def test_in_kernel_backward_matches_jax_chunked(rng, B, Lq, Lk, masked, row_chunk, H):
    a = _inputs(rng, B, Lq, Lk, H, masked)
    ct = tuple(rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, Lq, DK), (B, H, Lq, 24), (B, H, Lq, DK)))
    got = k1.ipa_attention_backward(
        _torch(a, "float32"), tuple(map(torch.from_numpy, ct)), row_chunk=row_chunk, **KW)
    want = _fused_backward_chunked(_jax(a, "float32"), tuple(map(jnp.asarray, ct)),
                                   row_chunk=row_chunk, **KW)
    assert len(got) == len(NAMES) and got[NAMES.index("pa")] is None
    assert got[NAMES.index("bias")] is None
    for name, g in zip(NAMES, got):
        if name in ("pa", "bias"):
            continue
        w = np.asarray(want[JAX_ORDER.index(name)], np.float32)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-3, err_msg=name)


def test_in_kernel_function_gradients_match_autograd_of_plain(rng):
    """The Function with ``w_pb`` carries history to every operand but the
    bias and ``pa``; its gradients equal autograd through the plain version
    within 1e-5 of each one's largest entry (f32), and it counts a backward."""
    a = _inputs(rng, 2, 9, 12, 4, masked_cols=3)
    ins = _torch(a, "float32")
    leaves = [None if t is None else t.clone().requires_grad_(n != "bias")
              for n, t in zip(NAMES, ins)]
    grad_names = [n for n in NAMES if n not in ("bias", "pa")]
    diff = [leaves[NAMES.index(n)] for n in grad_names]
    before, backwards = k1.launches_by_variant["w_pb"], k1.backward_calls
    outs = k1.ipa_attention(*leaves, **KW)
    cts = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)) for i, o in enumerate(outs)]
    got = torch.autograd.grad(outs, diff, cts)
    assert k1.backward_calls == backwards + 1
    assert k1.launches_by_variant["w_pb"] == before  # CPU tensors: the plain version
    ref = [None if t is None else t.detach().clone().requires_grad_(n != "bias")
           for n, t in zip(NAMES, ins)]
    want = torch.autograd.grad(k1.ipa_attention_plain(*ref, **KW),
                               [ref[NAMES.index(n)] for n in grad_names], cts)
    for name, g, w in zip(grad_names, got, want):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item(), name


SMALL = dict(dim_model=64, dim_pair=32, num_layers=2, num_heads=4, dim_hidden=128, dropout=0.1)


def _model_inputs(rng, B=2, L=10):
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(B * L)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    return (
        rng.standard_normal((B, L, 3)).astype(np.float32),
        rot.reshape(B, L, 3, 3).astype(np.float32),
        rng.uniform(0.01, 0.99, B).astype(np.float32),
        rng.standard_normal((B, L, 384)).astype(np.float32),
        (rng.standard_normal((B, L, L, 128)) * 0.5).astype(np.float32),
    )


@pytest.fixture(scope="module")
def flax_and_port():
    rng = np.random.default_rng(4)
    args = _model_inputs(rng)
    flax_model = FlaxDiG(**SMALL, use_pallas=False)
    variables = jax.jit(flax_model.init)(jax.random.key(2), *map(jnp.asarray, args))
    variables = jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), variables
    )
    port = TorchDiG(**SMALL).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return flax_model, variables, port, rng


@pytest.mark.parametrize("masked", [0, 2])
def test_model_without_pa_matches_flax_unfused(flax_and_port, masked):
    flax_model, variables, port, rng = flax_and_port
    pos, rot, t, single, pair = _model_inputs(rng)
    mask = np.ones(pos.shape[:2], bool)
    if masked:
        mask[:, -masked:] = False
    cache_j = flax_model.apply(variables, jnp.asarray(single), jnp.asarray(pair), jnp.asarray(mask),
                               method="embed_conditioning")
    assert "pa" not in cache_j
    want = flax_model.apply(variables, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(t), cache_j,
                            method="score_from_cache")
    with torch.no_grad():
        cache = port.embed_conditioning(torch.from_numpy(single), torch.from_numpy(pair),
                                        torch.from_numpy(mask), with_pa=False)
        assert "pa" not in cache
        got = port.score_from_cache(*map(torch.from_numpy, (pos, rot, t)), cache)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_model_without_pa_equals_with_pa(flax_and_port):
    _, _, port, rng = flax_and_port
    pos, rot, t, single, pair = map(torch.from_numpy, _model_inputs(rng))
    with torch.no_grad():
        outs = [
            port.score_from_cache(pos, rot, t, port.embed_conditioning(single, pair, with_pa=w))
            for w in (False, True)
        ]
    for g, w in zip(*outs):
        torch.testing.assert_close(g, w, atol=1e-5 * max(1.0, w.abs().max().item()), rtol=0)
