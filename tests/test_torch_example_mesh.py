"""The training example's ``--mesh`` (data=2, model=4: one head of width 8 a
tensor-parallel rank) and K1 at 1 and 2 heads, on the CPU.

* ``examples/torch_train_from_scratch.py --mesh --device cpu`` at 3 steps
  runs 8 gloo ranks (``parallel/programs.py::example_rank``) and prints the
  JAX example's mesh line; its losses and final weights match the
  one-process example's at the same steps (``MESH_LOSS_RTOL`` relative;
  ``MESH_WEIGHT_TOL`` of each tensor's largest entry: AdamW divides each
  gradient entry by its own running root mean square, so where an entry's
  gradient is near zero the rounding of its sums, taken over the heads and
  the batch halves in another order, moves the update by up to about 1% of
  the learning rate; after 3 steps the largest gap on the CPU is 3.6e-5 of
  layer 0's ``scalar_query``, every other tensor's within 2e-5, the losses
  within 1.1e-7). The one-process
  example is held against JAX step for step by
  ``tests/test_torch_examples.py``; JAX's own mesh run gives its one-device
  losses to 7e-7 and is too slow (55 s) to re-run here.
* K1's plain version at 1 and 2 heads of width 8 and 16, the streamed pair
  bias, f32 (the widths of routes "h1s" and "h2s"), against JAX's
  ``fused_ipa_attention`` in interpret mode, padded and masked
  (``FWD_TOL``); its backward (``ipa_attention_backward``) and the backward
  kernel's algebra (``ipa_attention_backward_h4_tiled``, what "bwd_h1s" and
  "bwd_h2s" compute) against ``jax.grad`` through
  ``fused_ipa_attention_diff`` (``BWD_ATOL`` absolute, ``BWD_RTOL``
  relative).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import ipa_attention as k1
from se3diff_tpu.ops.pallas_ipa import NEG_INF, fused_ipa_attention, fused_ipa_attention_diff

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
MESH_STEPS = 3
MESH_LOSS_RTOL = 1e-5
MESH_WEIGHT_TOL = 1e-4
FWD_TOL = 2e-5
BWD_ATOL, BWD_RTOL = 1e-4, 1e-3
NAMES = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa")
# JAX's operands: w_pb before w_pv, pa last.
JAX_ORDER = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pb", "w_pv", "bias", "pa")


@pytest.fixture(scope="module")
def torch_example():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import torch_train_from_scratch as module
    finally:
        sys.path.remove(str(EXAMPLES))
    return module


def test_example_mesh_matches_one_process(torch_example, tmp_path, capsys):
    """8 gloo ranks (2 batch halves x 4 heads) against one process on the
    same seed: the global losses, the full weights rank 0 gathers, every
    rank's attention at one head (its backward passes, "torch" on the CPU:
    2 layers a step)."""
    mesh = torch_example.main(["--mesh", "--device", "cpu", "--steps", str(MESH_STEPS),
                               "--ckpt_dir", str(tmp_path / "mesh")])
    assert "training on mesh {'data': 2, 'model': 4}" in capsys.readouterr().out
    one = torch_example.main(["--device", "cpu", "--steps", str(MESH_STEPS),
                              "--ckpt_dir", str(tmp_path / "one")])
    assert len(mesh["history"]) == len(one["history"]) == MESH_STEPS
    np.testing.assert_allclose(mesh["history"], one["history"], rtol=MESH_LOSS_RTOL)
    assert mesh["weights"].keys() == one["weights"].keys()
    for name, w in one["weights"].items():
        assert mesh["weights"][name].shape == w.shape, name
        if w.numel() == 0:
            continue
        gap = (mesh["weights"][name] - w).abs().max().item()
        assert gap <= MESH_WEIGHT_TOL * max(w.abs().max().item(), 1e-30), name
    ranks = mesh["ranks"]
    assert [r["rank"] for r in ranks] == list(range(8))
    layers = torch_example.JAX_MODEL["num_layers"]
    for r in ranks:
        assert r["history"] == mesh["history"]
        assert r["backward_calls"] == layers * MESH_STEPS
        assert r["backward_calls_by_route"]["torch"] == layers * MESH_STEPS
    # Rank 0 wrote the checkpoints in the one-device layout.
    last = torch.load(tmp_path / "mesh" / f"step_{MESH_STEPS:08d}.pt", weights_only=True)
    for name, w in last["model"].items():
        assert torch.equal(w, mesh["weights"][name]), name


def _inputs(rng, H, dk, cp, B, Lq, Lk, masked):
    """Kernel-layout operands (float32 numpy; ``pa = x2d @ w_pb``) and the
    three cotangents."""
    g = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    if masked:
        bias[:, -masked:] = NEG_INF
    a = dict(q_s=g(B, H, Lq, dk), k_s=g(B, H, Lk, dk), v_s=g(B, H, Lk, dk),
             q_p=g(B, 3, H * 4, Lq, scale=0.6), k_p=g(B, 3, H * 4, Lk, scale=0.6),
             v_p=g(B, H, Lk, 24), x2d=g(B, Lq, Lk, cp, scale=0.5), w_pv=g(H, cp, dk, scale=0.3),
             bias=bias, w_pb=g(cp, H, scale=0.3))
    a["pa"] = np.einsum("bijp,ph->bhij", a["x2d"], a["w_pb"]).astype(np.float32)
    return a, (g(B, H, Lq, dk), g(B, H, Lq, 24), g(B, H, Lq, dk))


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


def _kw(dk):
    return dict(scalar_w=1.0 / np.sqrt(3 * dk), pair_w=1.0 / np.sqrt(3))


# (heads, head width, Cp, B, Lq, Lk, masked columns): a rank of the example
# at model=4 (one head of 8, Cp=16, its B=4 L=8) and at model=2 (two heads),
# ragged and masked rows and columns, the widths' largest Cp.
CASES = [(1, 8, 16, 4, 8, 8, 0), (2, 8, 16, 4, 8, 8, 0), (2, 16, 64, 2, 12, 16, 5),
         (1, 16, 36, 2, 9, 13, 2)]


@pytest.mark.parametrize("H,dk,cp,B,Lq,Lk,masked", CASES)
def test_plain_matches_pallas_kernel_at_one_and_two_heads(rng, H, dk, cp, B, Lq, Lk, masked):
    a, _ = _inputs(rng, H, dk, cp, B, Lq, Lk, masked)
    assert k1.kernel_route(torch.float32, H, dk, cp, True) == {1: "h1s", 2: "h2s"}[H]
    got = k1.ipa_attention(*(torch.from_numpy(a[n]) for n in NAMES), **_kw(dk))
    pq, pk = -(-Lq // 8) * 8, -(-Lk // 8) * 8
    ja = _pad(a, pq, pk)
    want = fused_ipa_attention(*(jnp.asarray(ja[n]) for n in JAX_ORDER), **_kw(dk), ti=8, tj=8,
                               interpret=True)
    for g, w, name in zip(got, want, ("scalar", "point", "pair")):
        assert g.shape == (B, H, Lq, 24 if name == "point" else dk), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32)[:, :, :Lq],
                                   atol=FWD_TOL, rtol=FWD_TOL, err_msg=name)


def _jax_grads(a, ct, kw):
    """``jax.grad`` through ``fused_ipa_attention_diff`` (interpret mode, its
    chunked backward) of the outputs' inner product with the cotangents."""
    def loss(*xs):
        outs = fused_ipa_attention_diff(*xs, **kw, ti=8, tj=8, interpret=True,
                                        backward="chunked")
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(outs, ct))

    grads = jax.grad(loss, argnums=tuple(range(len(JAX_ORDER))))(
        *(jnp.asarray(a[n]) for n in JAX_ORDER))
    return dict(zip(JAX_ORDER, grads))


@pytest.mark.parametrize("H,dk,cp,B,Lq,Lk,masked", CASES)
def test_backward_and_kernel_algebra_match_jax_grad_at_one_and_two_heads(rng, H, dk, cp, B, Lq,
                                                                         Lk, masked):
    a, ct = _inputs(rng, H, dk, cp, B, Lq, Lk, masked)
    assert k1.backward_route(torch.float32, H, dk, cp, True) == {1: "bwd_h1s", 2: "bwd_h2s"}[H]
    ins = [torch.from_numpy(a[n]) for n in NAMES]
    cts = tuple(torch.from_numpy(c) for c in ct)
    kw = _kw(dk)
    port = k1.ipa_attention_backward(ins, cts, **kw)
    tiled = k1.ipa_attention_backward_h4_tiled(ins, cts, **kw)
    pq, pk = -(-Lq // 8) * 8, -(-Lk // 8) * 8
    want = _jax_grads(_pad(a, pq, pk), tuple(
        np.pad(c, [(0, 0), (0, 0), (0, pq - Lq), (0, 0)]) for c in ct), kw)
    crop = {"q_s": (slice(None),) * 2 + (slice(0, Lq),), "q_p": (Ellipsis, slice(0, Lq)),
            "k_s": (slice(None),) * 2 + (slice(0, Lk),), "v_s": (slice(None),) * 2 + (slice(0, Lk),),
            "v_p": (slice(None),) * 2 + (slice(0, Lk),), "k_p": (Ellipsis, slice(0, Lk)),
            "x2d": (slice(None), slice(0, Lq), slice(0, Lk)),
            "pa": (slice(None), slice(None), slice(0, Lq), slice(0, Lk)), "w_pv": (Ellipsis,)}
    assert port[NAMES.index("bias")] is None and tiled[NAMES.index("bias")] is None
    for name, g, t, x in zip(NAMES, port, tiled, ins):
        if name == "bias":
            continue
        w = np.asarray(want[name], np.float32)[crop[name]]
        assert g.shape == t.shape == x.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), w, atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=name)
