"""DiG score network of the PyTorch port.

1. The reference's golden checkpoint loads with ``strict=True`` and gives
   the reference's recorded outputs at 2e-5 (the tolerance of
   tests/test_convert.py: the recording carries ~1.2e-5 of fp32 rounding).
2. On flax parameters carried over by ``state_dict_from_jax``, the port
   matches the flax model (``use_pallas=False``) at 1e-4 in f32: the port's
   attention core sums in another order and its point distances use the
   kernel's epsilon (1e-24 where the flax path adds 1e-12).
3. ``score_from_cache`` equals the one-shot forward exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.models.convert import load_checkpoint, state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG, HeadwiseLinear, init_weights
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.models.dig import HeadwiseLinear as FlaxHeadwiseLinear

DATA = Path(__file__).parent / "test_data" / "golden_dig"
TINY = dict(
    dim_hidden=2, dim_model=4, dim_pair=2, dim_single_rep=2, dropout=0.1,
    max_distance_relative=128, num_buckets=4, num_heads=1, num_layers=1,
)
SMALL = dict(dim_model=64, dim_pair=32, num_layers=2, num_heads=4, dim_hidden=128, dropout=0.1)


def _inputs(rng, B=2, L=12):
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(B * L)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    return (
        rng.standard_normal((B, L, 3)).astype(np.float32),
        rot.reshape(B, L, 3, 3).astype(np.float32),
        rng.uniform(0.01, 0.99, B).astype(np.float32),
        rng.standard_normal((B, L, 384)).astype(np.float32),
        (rng.standard_normal((B, L, L, 128)) * 0.5).astype(np.float32),
    )


def test_golden_forward_parity():
    with np.load(DATA / "inputs_expected.npz") as d:
        data = {k: d[k] for k in d}
    model = TorchDiG(**TINY).eval()
    model.load_state_dict(load_checkpoint(str(DATA / "state_dict.npz")), strict=True)
    with torch.no_grad():
        pos, rot = model(*(torch.from_numpy(data[k]) for k in ("pos", "rot", "t", "single", "pair")))
    np.testing.assert_allclose(pos.numpy(), data["expected_pos"], atol=2e-5)
    np.testing.assert_allclose(rot.numpy(), data["expected_rot"], atol=2e-5)


@pytest.fixture(scope="module")
def flax_and_port():
    rng = np.random.default_rng(0)
    args = _inputs(rng)
    flax_model = FlaxDiG(**SMALL, use_pallas=False)
    variables = jax.jit(flax_model.init)(jax.random.key(0), *map(jnp.asarray, args))
    # Spread the point weights and biases away from their inits.
    variables = jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), variables
    )
    port = TorchDiG(**SMALL).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return flax_model, variables, port, rng


@pytest.mark.parametrize("masked", [0, 3])
def test_port_matches_flax_model(flax_and_port, masked):
    flax_model, variables, port, rng = flax_and_port
    args = _inputs(rng)
    mask = np.ones(args[0].shape[:2], bool)
    if masked:
        mask[:, -masked:] = False
    want = jax.jit(flax_model.apply)(variables, *map(jnp.asarray, args), jnp.asarray(mask))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args), torch.from_numpy(mask))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_score_from_cache_equals_forward(flax_and_port):
    _, _, port, rng = flax_and_port
    pos, rot, t, single, pair = map(torch.from_numpy, _inputs(rng))
    with torch.no_grad():
        cache = port.embed_conditioning(single, pair)
        for _ in range(2):  # the cache is reusable across evaluations
            got = port.score_from_cache(pos, rot, t, cache)
            want = port(pos, rot, t, single, pair)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert cache["pa"].shape == (SMALL["num_layers"], 2, SMALL["num_heads"], 12, 12)


def test_bfloat16_model_tracks_float32(flax_and_port):
    """bf16 mode (projections, residual stream and pair stack in bf16) stays
    within 5e-2 of f32 relative to the output scale on the same weights."""
    _, _, port, rng = flax_and_port
    args = list(map(torch.from_numpy, _inputs(rng)))
    port16 = TorchDiG(**SMALL, dtype=torch.bfloat16).eval()
    port16.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        for g, w in zip(port16(*args), port(*args)):
            assert g.dtype == torch.float32
            assert (g - w).abs().max() <= 5e-2 * w.abs().max()


def test_headwise_linear_matches_flax(rng):
    """Per-head pair-value projection, f32 at 1e-5 (same products, summed in
    another order)."""
    H, cin, feat = 4, 8, 12
    kernel = rng.standard_normal((cin, feat)).astype(np.float32)
    x = rng.standard_normal((2, 5, H, cin)).astype(np.float32)
    want = FlaxHeadwiseLinear(features=feat, n_head=H).apply({"params": {"kernel": kernel}}, x)
    lin = HeadwiseLinear(cin, feat, H)
    lin.load_state_dict({"weight": torch.from_numpy(kernel.T.copy())})
    with torch.no_grad():
        got = lin(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=1e-5)


def test_init_weights_is_deterministic():
    a = init_weights(TorchDiG(**SMALL), torch.Generator().manual_seed(3)).state_dict()
    b = init_weights(TorchDiG(**SMALL), torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
