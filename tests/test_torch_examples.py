"""The port's examples against the JAX package's, on the CPU.

* ``examples/torch_train_from_scratch.py`` at 5 steps against
  ``examples/train_from_scratch.py`` at the same settings: the same batches
  (the port draws them as JAX's example does), JAX's initial weights carried
  across and JAX's noise of each step fed to the port's step, so each
  step's loss agrees within 1e-4 relative (f32 sums in another order,
  through 5 AdamW updates).
* ``examples/torch_prepare_megascale.py`` against
  ``examples/prepare_megascale.py`` on ``tests/test_prepare_megascale.py``'s
  fixture: the CSVs equal row for row. Text cells are equal. ``dG_ML`` is
  the input's value exactly in the port's files and within 4e-15 of it in
  JAX's: pandas' ``to_numeric`` is not correctly rounded (over 200,000
  values like these it is up to 1.8e-15 off Python's ``float``) and writes
  what it parsed. ``p_folded`` within 1e-6 (a float32 sigmoid in both,
  JAX's and torch's).
"""

import csv
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.training import dsm as tdsm
from se3diff_torch.training.dsm import DSMNoise

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
STEPS = 5


@pytest.fixture(scope="module")
def jax_example():
    return runpy.run_path(str(EXAMPLES / "train_from_scratch.py"), run_name="jax_train_from_scratch")


@pytest.fixture(scope="module")
def torch_example():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import torch_train_from_scratch as module
    finally:
        sys.path.remove(str(EXAMPLES))
    return module


def _jax_run(ex, tmp_path):
    """The JAX example's training at ``STEPS`` steps (its main, without the
    sampling), returning its initial weights, batches, SDEs and losses."""
    from se3diff_tpu.diffusion import denoise
    from se3diff_tpu.models.dig import DiGConditionalScoreModel
    from se3diff_tpu.sde.so3_sde import DiGSO3SDE
    from se3diff_tpu.sde.vpsde import CosineVPSDE
    from se3diff_tpu.training.loop import TrainConfig, train_dsm

    _, batch_fn = ex["make_dataset"](np.random.default_rng(0))
    model = DiGConditionalScoreModel(num_layers=2, dim_model=32, dim_pair=16, num_heads=4,
                                     dim_hidden=64, dropout=0.0)
    sdes = denoise.SDEs(pos=CosineVPSDE(),
                        node_orientations=DiGSO3SDE(num_sigma=32, num_omega=256, l_max=500))
    b0 = batch_fn(0)
    params = model.init(jax.random.key(0), b0["pos"][:1], b0["rot"][:1], jnp.ones((1,), jnp.float32),
                        b0["single"][:1], b0["pair"][:1])
    cfg = TrainConfig(num_steps=STEPS, lr=2e-3, warmup_steps=min(20, STEPS // 4), min_t=0.05,
                      ckpt_every=max(STEPS // 4, 1), ckpt_dir=str(tmp_path / "jax_ckpt"),
                      log_every=max(STEPS // 10, 1))
    _, history = train_dsm(sdes, model.apply, params, batch_fn, cfg, val_batch=batch_fn(10_000))
    return params, batch_fn, sdes, cfg, history


def _jax_noise(sdes, cfg, batch, step):
    """The noise JAX's train step draws at ``step`` (training/loop.py's
    fold_in, training/dsm.py's split)."""
    key = jax.random.fold_in(jax.random.key(cfg.seed), step)
    k_t, k_pos, k_rot = jax.random.split(key, 3)
    pos0 = jnp.asarray(batch["pos"])
    t = jax.random.uniform(k_t, (pos0.shape[0],), pos0.dtype, cfg.min_t, 1.0)
    z = jax.random.normal(k_pos, pos0.shape, pos0.dtype)
    rot_t = sdes.node_orientations.sample_marginal(k_rot, jnp.asarray(batch["rot"]), t)
    return DSMNoise(*(torch.from_numpy(np.array(x, np.float32)) for x in (t, z, rot_t)))


def test_train_from_scratch_matches_jax_step_for_step(jax_example, torch_example, tmp_path,
                                                      monkeypatch):
    params, jax_batch_fn, jsdes, jcfg, want = _jax_run(jax_example, tmp_path)
    assert len(want) == STEPS

    _, batch_fn = torch_example.make_dataset(np.random.default_rng(0))
    for step in (0, 3, 10_000):
        got, ref = batch_fn(step), jax_batch_fn(step)
        for k in ("pos", "single", "pair"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        np.testing.assert_allclose(got["rot"], np.asarray(ref["rot"]), atol=1e-6)

    built = []

    def jax_weights(cfg, device):
        assert cfg == torch_example.JAX_MODEL and device == "cpu"
        model = TorchDiG(**cfg)
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        built.append(model)
        return model

    steps = iter(range(STEPS))

    def noise_of_step(generator, batch, sdes, min_t):
        assert min_t == jcfg.min_t
        step = next(steps)
        return _jax_noise(jsdes, jcfg, jax_batch_fn(step), step)

    monkeypatch.setattr(torch_example, "build_model", jax_weights)
    monkeypatch.setattr(tdsm, "draw_noise", noise_of_step)
    out = torch_example.main(["--steps", str(STEPS), "--device", "cpu",
                              "--ckpt_dir", str(tmp_path / "torch_ckpt")])
    assert len(built) == 1 and out["model"] == torch_example.JAX_MODEL
    np.testing.assert_allclose(out["history"], want, rtol=1e-4)
    for k in ("d_model", "d_data", "d_prior"):
        assert np.isfinite(out[k]), k


def test_train_from_scratch_builds_the_jax_model_for_the_card(torch_example):
    """On the card the example trains the JAX example's model (4 heads of
    width 8, Cp=16), whose attention takes the 4-head designs: "h4s"
    forward, "bwd_h4s" backward. ``check_card_widths`` reads no device
    state, so this runs without a card."""
    from se3diff_torch.ops import ipa_attention as k1

    cfg = torch_example.model_config("cuda")
    assert cfg == torch_example.JAX_MODEL == dict(
        num_layers=2, dim_model=32, dim_pair=16, num_heads=4, dim_hidden=64, dropout=0.0)
    assert not hasattr(torch_example, "CARD_MODEL")
    H, dk, cp = cfg["num_heads"], cfg["dim_model"] // cfg["num_heads"], cfg["dim_pair"]
    assert k1.kernel_route(torch.float32, H, dk, cp, True) == "h4s"
    assert k1.backward_route(torch.float32, H, dk, cp, True) == "bwd_h4s"


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture
def mega_csv(tmp_path):
    """tests/test_prepare_megascale.py's fixture."""
    import pandas as pd

    rng = np.random.default_rng(0)
    n = 100
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=int(l)))
            for l in rng.integers(30, 80, n)]
    dg = [str(v) for v in rng.standard_normal(n) * 2]
    dg[5] = "-"  # MEGAScale has non-numeric dG_ML rows; they must be dropped
    df = pd.DataFrame({"aa_seq": seqs, "dG_ML": dg, "name": [f"m{i}" for i in range(n)]})
    path = tmp_path / "mega.csv"
    df.to_csv(path, index=False)
    return path


def test_prepare_megascale_matches_jax(mega_csv, tmp_path):
    jax_main = runpy.run_path(str(EXAMPLES / "prepare_megascale.py"), run_name="prepare_megascale")["main"]
    torch_main = runpy.run_path(str(EXAMPLES / "torch_prepare_megascale.py"),
                                run_name="torch_prepare_megascale")["main"]
    jax_main(["--input_csv", str(mega_csv), "--output_dir", str(tmp_path / "jax")])
    torch_main(["--input_csv", str(mega_csv), "--output_dir", str(tmp_path / "torch")])
    dg_in = {r[2]: float(r[1]) for r in _rows(mega_csv)[1:] if r[1] != "-"}
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert len(names) == 6
    for name in names:
        want, got = _rows(tmp_path / "jax" / name), _rows(tmp_path / "torch" / name)
        assert got[0] == want[0] and len(got) == len(want), name
        dg, pf = want[0].index("dG_ML"), want[0].index("p_folded")
        for g, w in zip(got[1:], want[1:]):
            text = [k for k in range(len(w)) if k not in (dg, pf)]
            assert [g[k] for k in text] == [w[k] for k in text], name
            assert float(g[dg]) == dg_in[g[want[0].index("name")]], name
            assert abs(float(w[dg]) - float(g[dg])) <= 4e-15, name
            assert float(g[pf]) == pytest.approx(float(w[pf]), abs=1e-6), name
