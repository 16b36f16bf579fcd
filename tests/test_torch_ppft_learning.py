"""The PPFT learning run's scripts in the port against the JAX scripts.

``scripts/torch_pretrain_sh3_prior.py`` and ``scripts/torch_ppft_trainer_run.py``
port ``scripts/pretrain_sh3_prior.py`` and ``scripts/ppft_trainer_run_r5.py``.
Held here on the CPU:

* ``count_params`` equals the JAX package's on the same weights (tiny
  widths, carried across by ``state_dict_from_jax``) and reads 31.28M at
  bioemu-v1.0 widths, the JAX prior's recorded size;
* the mutant sequences are the JAX script's, the ensemble positions equal
  its bit for bit (the same numpy draws) and the rotations within 1e-6 (two
  libraries' f32 ``rotvec_to_rotmat``);
* the train/validation split equals the JAX script's pandas lines on the
  real GRB2-SH3 CSV: the same ids, h* within 1e-12;
* ``--tiny --device cpu`` runs of both scripts: the prior's ``params.npz``
  loads into JAX's ``load_torch_checkpoint`` and the JAX model scores
  seeded inputs like the port's, at ``tests/test_torch_dig.py``'s f32
  tolerance (1e-4 of the largest output); the fine-tuning run writes
  ``history.json`` for epochs 0..N and ``finetune_model.npz`` equal to the
  best epoch's checkpoint;
* importing and starting the scripts loads no JAX, flax, optax, pandas or
  ``se3diff_tpu``, and without a card they refuse to start unless asked
  for the CPU.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG, count_params
from se3diff_torch.struct.atoms import frames_from_atom37
from se3diff_torch.struct.pdb import read_pdb
from se3diff_tpu.models.convert import load_torch_checkpoint
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.models.dig import count_params as jax_count_params

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
GRB2_CSV = REPO / "assets" / "reference_h" / "GRB2_SH3_high_confidence.csv"
SH3_PDB = REPO / "assets" / "structures" / "2vwf_trimmed_SH3.pdb"
TINY = dict(num_layers=1, dim_model=16, dim_pair=8, num_heads=2, dim_hidden=16, dropout=0.0)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return {
        "port_prior": _load("torch_pretrain_sh3_prior", SCRIPTS / "torch_pretrain_sh3_prior.py"),
        "port_ppft": _load("torch_ppft_trainer_run", SCRIPTS / "torch_ppft_trainer_run.py"),
        "jax_prior": _load("pretrain_sh3_prior", SCRIPTS / "pretrain_sh3_prior.py"),
    }


def _score_inputs(rng, B=2, L=56):
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(B * L)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    return (
        (rng.standard_normal((B, L, 3)) * 0.5).astype(np.float32),
        rot.reshape(B, L, 3, 3).astype(np.float32),
        rng.uniform(0.05, 0.99, B).astype(np.float32),
        rng.standard_normal((B, L, 384)).astype(np.float32),
        (rng.standard_normal((B, L, L, 128)) * 0.5).astype(np.float32),
    )


def test_count_params_matches_jax():
    args = _score_inputs(np.random.default_rng(0), L=12)
    variables = jax.jit(FlaxDiG(**TINY, use_pallas=False).init)(
        jax.random.key(0), *map(jnp.asarray, args))
    port = TorchDiG(**TINY)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert count_params(port) == jax_count_params(variables) > 0
    # The sentinel buffer rides in the state dict but is no parameter.
    assert "model_nn.step_emb.dummy" in port.state_dict()

    recorded = json.loads((REPO / "docs" / "artifacts" / "sh3_prior_train_r4.json").read_text())
    assert round(count_params(TorchDiG()) / 1e6, 2) == recorded["summary"]["params_M"] == 31.28


def test_mutants_and_ensemble_match_jax(scripts):
    port, ref = scripts["port_prior"], scripts["jax_prior"]
    for seed, val_size, steps in ((0, 4, 60), (0, 1, 2), (3, 2, 10)):
        want = ref.mutant_sequences(str(GRB2_CSV), seed, val_size, steps)
        assert port.mutant_sequences(str(GRB2_CSV), seed, val_size, steps) == want

    ref_pos, ref_rot = frames_from_atom37(read_pdb(str(SH3_PDB)).atom37[0])
    ref_pos = (ref_pos - ref_pos.mean(0, keepdims=True)).astype(np.float32)
    # Two conformer sets off one generator, as the scripts draw one a mutant.
    rng_port, rng_jax = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(2):
        pos, rot = port.make_ensemble(ref_pos, ref_rot, 16, rng_port, 0.15, 0.42)
        pos_j, rot_j = ref.make_ensemble(ref_pos, ref_rot, 16, rng_jax, 0.15, 0.42)
        assert pos.dtype == rot.dtype == np.float32 and pos.shape == (16, ref_pos.shape[0], 3)
        np.testing.assert_array_equal(pos, pos_j)
        np.testing.assert_allclose(rot, rot_j, rtol=0, atol=1e-6)


def test_split_matches_jax_on_grb2_csv(scripts, tmp_path):
    port = scripts["port_ppft"]
    for seed, val_size, train_mutants in ((0, 4, 25), (0, 2, 3), (5, 3, 40)):
        # scripts/ppft_trainer_run_r5.py's split, verbatim.
        df = pd.read_csv(GRB2_CSV)
        df["h_star"] = 1.0 / (1.0 + np.exp(df["f_dg_pred"].to_numpy(np.float64)))
        order = np.random.default_rng(seed).permutation(len(df))
        want = {
            "train": df.iloc[order[val_size:val_size + train_mutants]][["id", "seq", "h_star"]],
            "val": df.iloc[order[:val_size]][["id", "seq", "h_star"]],
        }
        rows = dict(zip(("train", "val"), port.split_rows(GRB2_CSV, seed, val_size, train_mutants)))
        for name, expect in want.items():
            port.write_rows(tmp_path / f"{name}.csv", rows[name])
            got = pd.read_csv(tmp_path / f"{name}.csv")
            assert list(got.columns) == ["id", "seq", "h_star"]
            assert got["id"].tolist() == expect["id"].tolist()
            assert got["seq"].tolist() == expect["seq"].tolist()
            np.testing.assert_allclose(got["h_star"], expect["h_star"], rtol=0, atol=1e-12)


def test_tiny_prior_loads_into_jax(scripts, tmp_path):
    ckpt = tmp_path / "prior"
    model, summary = scripts["port_prior"].main(
        ["--tiny", "--device", "cpu", "--ckpt_dir", str(ckpt), "--output", str(tmp_path / "p.json")])
    artifact = json.loads((tmp_path / "p.json").read_text())
    assert np.isfinite(artifact["loss_history"]).all() and artifact["summary"]["device"] == "cpu"
    assert summary["sampled_h"] is not None and 0.0 <= summary["sampled_h"]["mean"] <= 1.0
    assert summary["params_M"] == round(count_params(model) / 1e6, 2)

    args = _score_inputs(np.random.default_rng(2))
    variables = load_torch_checkpoint(str(ckpt / "params.npz"))
    want = FlaxDiG(**TINY, use_pallas=False).apply(variables, *map(jnp.asarray, args))
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_tiny_ppft_run_writes_history_and_best(scripts, tmp_path):
    out = tmp_path / "ppft"
    best = scripts["port_ppft"].main(["--tiny", "--device", "cpu", "--output_dir", str(out)])
    hist = json.loads((out / "history.json").read_text())
    epochs = hist["config"]["num_epochs"]
    assert epochs == 2
    assert [e["epoch"] for e in hist["val"]] == list(range(epochs + 1))
    assert [e["epoch"] for e in hist["train"]] == list(range(1, epochs + 1))
    assert all(np.isfinite([e["val_loss"], e["val_path_kl"]]).all() for e in hist["val"])
    assert hist["val"][0]["val_path_kl"] < 1e-6  # the near-zero control
    assert len(pd.read_csv(out / "train.csv")) == 3 and len(pd.read_csv(out / "val.csv")) == 2
    with np.load(out / "finetune_model.npz") as a, \
            np.load(out / f"finetune_model_{hist['best_epoch']}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], best[k].numpy())


def test_scripts_import_no_jax_and_refuse_without_card():
    code = (
        "import importlib.util, sys, torch\n"
        "mods = []\n"
        "for name in ('torch_pretrain_sh3_prior', 'torch_ppft_trainer_run'):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'scripts/{name}.py')\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(m)\n"
        "    mods.append(m)\n"
        "refused = []\n"
        "if not torch.cuda.is_available():\n"
        "    for m in mods:\n"
        "        try:\n"
        "            m.main(['--ckpt_dir' if m.__name__.endswith('prior') else '--output_dir',"
        " '/nonexistent/x'])\n"
        "        except RuntimeError as e:\n"
        "            refused.append('--device cpu' in str(e))\n"
        "    assert refused == [True, True], refused\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'se3diff_tpu'))\n"
        "print(refused, bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
