"""Multi-rank sampling of the PyTorch port: sequence parallelism (SP) and
data parallelism (DP) on ``torch.distributed``, on the CPU with gloo ranks.

1. ``sp_ipa_attention`` on every rank's row slab, concatenated, against the
   JAX ``sp_fused_ipa_attention`` (Pallas kernel in interpret mode on 2- and
   4-way ``model`` meshes), at 1e-5 as the JAX SP tests hold their kernel:
   f32, sums in another order. The ragged case (L=150 on 4 ranks) pads rows
   to 192 for JAX; the port does not pad, so only real rows are compared.
2. The SP score network on spawned gloo ranks (``file://`` rendezvous in the
   test's tmp dir) against the JAX model with ``pair_sharding`` on a 2-way
   mesh and the fused kernel, at 2e-5 (tests/test_parallel.py's SP
   tolerance); and on 4 ranks with slabs of 3/3/2/2 rows against the port
   without SP, at 1e-5.
3. DP sampling on two ranks against the single-process batch of the same
   seed, at 2e-4 (tests/test_parallel.py's DP tolerance; the solver runs 30
   steps on per-rank batches whose products round in another order), with
   dpm_2m and with the stochastic heun and euler_maruyama, whose ranks draw
   each step's normals for the whole batch and keep their rows.
4. The CLI with ``--sp 2 --device cpu`` writes the files of the run without
   ``--sp``, coordinates within 1e-4; ``--sp 2 --device cuda`` without GPUs
   raises.
5. No module of the port imports JAX or the JAX package.

Every spawning test bounds its ranks' collectives (group timeout) and the
whole run (join timeout), so a hung rank fails the test.
"""

import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import se3diff_torch.sample as torch_cli
from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.ops import ipa_attention as k1
from se3diff_torch.parallel import launch, programs, row_slabs, run_ranks
from se3diff_torch.sampling.bundle import random_bundle
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.ops.pallas_ipa import col_padded_len, sp_fused_ipa_attention
from tests.test_bundle import TINY_CONFIG
from tests.test_torch_ipa_attention import PAIR_W, SCALAR_W, _inputs, _jax_args, _pa, _pad

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT = 120.0
SMALL = dict(dim_model=16, dim_pair=8, num_layers=2, num_heads=2, dim_hidden=16, dropout=0.0)


def _model_sharding(mp, spec):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8 // mp, mp), ("data", "model"))
    return NamedSharding(mesh, spec)


def _port_slabs(a, pa, world, L):
    """Every rank's slab through ``sp_ipa_attention``, concatenated by rows."""
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != "w_pb"}
    pa_t = torch.from_numpy(pa)
    slabs = []
    for r0, r1 in row_slabs(L, world):
        slabs.append(k1.sp_ipa_attention(
            (r0, r1), t["q_s"][:, :, r0:r1].contiguous(), t["k_s"], t["v_s"],
            t["q_p"][..., r0:r1].contiguous(), t["k_p"], t["v_p"],
            t["x2d"][:, r0:r1].contiguous(), t["w_pv"], t["bias"],
            pa_t[:, :, r0:r1].contiguous(), scalar_w=SCALAR_W, pair_w=PAIR_W,
        ))
    return [torch.cat([s[i] for s in slabs], dim=2).numpy() for i in range(3)]


@pytest.mark.parametrize("L,world,Lq,streamed_pa", [
    (256, 2, 256, True), (256, 4, 256, True), (256, 2, 256, False), (256, 4, 256, False),
    (150, 4, 192, True),   # ragged: 38/38/37/37 rows; JAX pads to 4 x 48
])
def test_sp_ipa_attention_matches_jax_sp_kernel(rng, L, world, Lq, streamed_pa):
    a = _inputs(rng, 1, L, L, masked_cols=5)
    pa = _pa(a)
    got = _port_slabs(a, pa, world, L)
    ja, jpa = _pad(a, pa, Lq, col_padded_len(L))
    args = _jax_args(ja, "float32")
    extra = (jnp.asarray(jpa),) if streamed_pa else ()
    want = sp_fused_ipa_attention(
        _model_sharding(world, P(None, "model", None, None)), *args, *extra,
        scalar_w=SCALAR_W, pair_w=PAIR_W, interpret=True,
    )
    for g, w, name in zip(got, want, ("scalar", "point", "pair")):
        np.testing.assert_allclose(g, np.asarray(w, np.float32)[:, :, :L], atol=1e-5, err_msg=name)


def test_sp_ipa_attention_on_one_rank_is_ipa_attention(rng):
    a = _inputs(rng, 1, 12, 12, masked_cols=3)
    pa = _pa(a)
    whole = _port_slabs(a, pa, 1, 12)
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != "w_pb"}
    plain = k1.ipa_attention(
        t["q_s"], t["k_s"], t["v_s"], t["q_p"], t["k_p"], t["v_p"], t["x2d"], t["w_pv"],
        t["bias"], torch.from_numpy(pa), scalar_w=SCALAR_W, pair_w=PAIR_W,
    )
    for g, w in zip(whole, plain):
        np.testing.assert_array_equal(g, w.numpy())
    with pytest.raises(ValueError, match="rows"):
        k1.sp_ipa_attention((0, 6), t["q_s"], t["k_s"], t["v_s"], t["q_p"], t["k_p"], t["v_p"],
                            t["x2d"], t["w_pv"], t["bias"], torch.from_numpy(pa),
                            scalar_w=SCALAR_W, pair_w=PAIR_W)


def test_row_slabs_and_batch_helpers():
    from se3diff_torch.parallel import largest_pow2_leq, pick_model_parallel, round_up_batch

    assert row_slabs(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert row_slabs(300, 2) == [(0, 150), (150, 300)]
    assert [r1 - r0 for r0, r1 in row_slabs(301, 4)] == [76, 75, 75, 75]
    with pytest.raises(ValueError):
        row_slabs(3, 4)
    assert round_up_batch(10, 4) == 12 and round_up_batch(8, 4) == 8
    assert pick_model_parallel(8, 32) == 8 and pick_model_parallel(6, 32) == 2
    assert largest_pow2_leq(100) == 64 and largest_pow2_leq(0) == 1


def _score_inputs(rng, B, L):
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(B * L)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    return (
        rng.standard_normal((B, L, 3)).astype(np.float32),
        rot.reshape(B, L, 3, 3).astype(np.float32),
        rng.uniform(0.05, 0.95, B).astype(np.float32),
        rng.standard_normal((B, L, 384)).astype(np.float32),
        (rng.standard_normal((B, L, L, 128)) * 0.5).astype(np.float32),
    )


@pytest.fixture(scope="module")
def flax_weights():
    rng = np.random.default_rng(5)
    args = _score_inputs(rng, 1, 8)
    variables = jax.jit(FlaxDiG(**SMALL).init)(jax.random.key(0), *map(jnp.asarray, args))
    # Spread the point weights and biases away from their inits.
    variables = jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), variables
    )
    return variables, {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}


def test_sp_model_matches_jax_pair_sharded_model(tmp_path, flax_weights):
    variables, sd = flax_weights
    inputs = _score_inputs(np.random.default_rng(6), 2, 12)
    pos, rot, t, single, pair = map(jnp.asarray, inputs)
    jax_sp = FlaxDiG(**SMALL, use_pallas=True,
                     pair_sharding=_model_sharding(2, P(None, "model")))
    cache = jax_sp.apply(variables, single, pair, method="embed_conditioning")
    want = jax_sp.apply(variables, pos, rot, t, cache, method="score_from_cache")

    outs = run_ranks(programs.sp_score, 2, ["cpu", "cpu"], args=(SMALL, sd, inputs),
                     timeout=JOIN_TIMEOUT, group_timeout=GROUP_TIMEOUT, rendezvous_dir=str(tmp_path))
    assert [o["rows"] for o in outs] == [(0, 6), (6, 12)]
    for o in outs:
        assert o["launches"] == 0   # CPU tensors take the plain version
        assert o["launches_by_route"] == dict.fromkeys(k1._ROUTE_SYMBOLS, 0)
        np.testing.assert_allclose(o["pos"], np.asarray(want[0], np.float32), atol=2e-5)
        np.testing.assert_allclose(o["rot"], np.asarray(want[1], np.float32), atol=2e-5)


def test_sp_model_on_ragged_slabs_matches_one_process(tmp_path, flax_weights):
    _, sd = flax_weights
    inputs = _score_inputs(np.random.default_rng(7), 2, 10)
    mask = np.ones((2, 10), bool)
    mask[1, -2:] = False
    model = TorchDiG(**SMALL).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        want = model(*map(torch.from_numpy, inputs), torch.from_numpy(mask))

    outs = run_ranks(programs.sp_score, 4, ["cpu"] * 4, args=(SMALL, sd, (*inputs, mask)),
                     timeout=JOIN_TIMEOUT, group_timeout=GROUP_TIMEOUT, rendezvous_dir=str(tmp_path))
    assert [o["rows"] for o in outs] == [(0, 3), (3, 6), (6, 8), (8, 10)]
    for o in outs:
        np.testing.assert_array_equal(o["pos"], outs[0]["pos"])   # the same on every rank
        np.testing.assert_allclose(o["pos"], want[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(o["rot"], want[1].numpy(), atol=1e-5)


def test_dp_sampling_reproduces_the_single_process_batch(tmp_path):
    L, batch, seed = 6, 3, 11   # 3 samples on 2 ranks: rounded up to 4, one trimmed
    bundle_kwargs = dict(model_cfg=SMALL, denoiser="dpm_2m", seed=0,
                         so3_kwargs=dict(num_sigma=24, num_omega=128, l_max=100))
    rng = np.random.default_rng(0)
    single = (rng.standard_normal((L, 384)) * 0.3).astype(np.float32)
    pair = (rng.standard_normal((L, L, 128)) * 0.1).astype(np.float32)
    bundle = random_bundle(**bundle_kwargs, device="cpu")
    pos_ref, rot_ref = bundle.sampler(batch, L)(
        torch.Generator().manual_seed(seed), torch.from_numpy(single), torch.from_numpy(pair)
    )

    outs = run_ranks(programs.dp_sample, 2, ["cpu", "cpu"],
                     args=(bundle_kwargs, single, pair, batch, seed),
                     timeout=JOIN_TIMEOUT, group_timeout=GROUP_TIMEOUT, rendezvous_dir=str(tmp_path))
    for o in outs:
        assert o["pos"].shape == (batch, L, 3) and o["node_orientations"].shape == (batch, L, 3, 3)
        np.testing.assert_allclose(o["pos"], pos_ref.numpy(), atol=2e-4)
        np.testing.assert_allclose(o["node_orientations"], rot_ref.numpy(), atol=2e-4)


@pytest.mark.parametrize("target", ["heun_denoiser", "euler_maruyama_predictor"])
def test_dp_sampling_with_per_step_noise_reproduces_one_process(tmp_path, target):
    L, batch, seed = 6, 3, 11   # 3 samples on 2 ranks: rounded up to 4, one trimmed
    denoiser = {"_target_": target, "num_steps": 8, "max_t": 0.99, "min_t": 0.001}
    bundle_kwargs = dict(model_cfg=SMALL, denoiser=denoiser, seed=0,
                         so3_kwargs=dict(num_sigma=24, num_omega=128, l_max=100))
    rng = np.random.default_rng(0)
    single = (rng.standard_normal((L, 384)) * 0.3).astype(np.float32)
    pair = (rng.standard_normal((L, L, 128)) * 0.1).astype(np.float32)
    bundle = random_bundle(**bundle_kwargs, device="cpu")
    pos_ref, rot_ref = bundle.sampler(batch, L)(
        torch.Generator().manual_seed(seed), torch.from_numpy(single), torch.from_numpy(pair)
    )
    assert torch.isfinite(pos_ref).all() and torch.isfinite(rot_ref).all()

    outs = run_ranks(programs.dp_sample, 2, ["cpu", "cpu"],
                     args=(bundle_kwargs, single, pair, batch, seed),
                     timeout=JOIN_TIMEOUT, group_timeout=GROUP_TIMEOUT, rendezvous_dir=str(tmp_path))
    for o in outs:
        assert o["pos"].shape == (batch, L, 3) and o["node_orientations"].shape == (batch, L, 3, 3)
        np.testing.assert_allclose(o["pos"], pos_ref.numpy(), atol=2e-4)
        np.testing.assert_allclose(o["node_orientations"], rot_ref.numpy(), atol=2e-4)


def _records(path):
    """PDB records with the coordinate columns blanked."""
    return [line[:30] + line[54:] for line in path.read_text().splitlines()]


def test_cli_sp_writes_the_files_of_one_process(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    with np.load(REPO / "tests/test_data/golden_dig/state_dict.npz") as sd:
        torch.save({k: torch.from_numpy(np.asarray(sd[k])) for k in sd}, ckpt / "checkpoint.ckpt")
    (ckpt / "config.yaml").write_text(TINY_CONFIG)

    def argv(out):
        return [
            "--sequence", "GYDPETGTWG", "--num_samples", "3", "--output_dir", str(out),
            "--ckpt_path", str(ckpt / "checkpoint.ckpt"), "--denoiser", "dpm_fast",
            "--embeds_backend", "dummy", "--cache_embeds_dir", str(tmp_path / "embeds"),
            "--so3_cache_dir", str(tmp_path / "so3"), "--exact_batch_size", "2",
            "--no-filter_samples", "--device", "cpu",
        ]

    def bounded(*args, **kwargs):
        return run_ranks(*args, **kwargs, timeout=JOIN_TIMEOUT, group_timeout=GROUP_TIMEOUT,
                         rendezvous_dir=str(tmp_path))

    monkeypatch.setattr(launch, "run_ranks", bounded)
    one, sp = tmp_path / "one", tmp_path / "sp"
    torch_cli.main(argv(one))
    torch_cli.main(argv(sp) + ["--sp", "2"])

    names = sorted(p.name for p in sp.iterdir())
    assert names == sorted(p.name for p in one.iterdir())
    assert "batch_0000000_0000002.npz" in names and "topology.pdb" in names
    for npz in one.glob("batch_*.npz"):
        with np.load(npz) as a, np.load(sp / npz.name) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_allclose(b["pos"], a["pos"], atol=1e-4)
            np.testing.assert_allclose(b["node_orientations"], a["node_orientations"], atol=1e-4)
    assert _records(sp / "topology.pdb") == _records(one / "topology.pdb")


def test_cli_sp_on_cuda_without_gpus_exits(tmp_path):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are visible; the error path needs fewer")
    with pytest.raises(SystemExit, match="GPUs are visible"):
        torch_cli.main(["--sequence", "GYDPETGTWG", "--num_samples", "1",
                        "--output_dir", str(tmp_path / "o"), "--sp", "2", "--device", "cuda"])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of se3diff_torch, imported in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import se3diff_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(se3diff_torch.__path__, 'se3diff_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'se3diff_torch.parallel.programs' in names, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'se3diff_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
