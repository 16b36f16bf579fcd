"""The port's samplers and recorders as users reach them: registries, the
reference YAMLs, the generator's draws and the CLIs, on the CPU.

1. ``make_denoiser`` offers the JAX package's five sampler names with its
   step counts, and every YAML in ``se3diff_tpu/config/denoiser/`` (read, not
   copied) instantiates in the port as the partial JAX builds from it.
2. The public ``euler_maruyama`` and ``heun`` draw the prior, then each
   step's positions' and rotations' normals, from their generator: a replay
   of those draws through ``solve_from`` gives the same batch bit for bit.
   ``sde_dpm_solver_finetune`` draws only its prior.
3. The sample CLI runs ``--denoiser heun`` and ``--denoiser euler_maruyama``
   at their full step counts on a tiny checkpoint; the finetune CLI records
   with ``sde_dpm_solver_finetune`` (by ``--denoiser_type`` and by the
   reference YAML) and refuses a sampling denoiser's YAML.
(The trajectories themselves are held against JAX in
tests/test_torch_denoise.py, tests/test_torch_finetune.py and, under data
parallelism, tests/test_torch_parallel.py.)
"""

from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import se3diff_torch.sample as sample_cli
from se3diff_torch import finetune as finetune_cli
from se3diff_torch.diffusion import denoise as tden
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.models.dig import init_weights
from se3diff_torch.ppft import trainer as ttr
from se3diff_torch.sampling import bundle as tbd
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchSO3
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchVP
from se3diff_tpu.ppft import trainer as jtr
from se3diff_tpu.sampling import bundle as jbd
from tests.test_bundle import TINY_CONFIG as TINY_SAMPLE_CONFIG
from tests.test_torch_finetune import FT_CFG, TINY_CONFIG as TINY_FINETUNE_CONFIG

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "assets"
DENOISER_YAMLS = sorted((REPO / "se3diff_tpu" / "config" / "denoiser").glob("*.yaml"))
SO3 = dict(num_sigma=32, num_omega=128, l_max=100, sigma_max=1.65, eps_t=1e-3)


@pytest.fixture(scope="module")
def sdes(tmp_path_factory):
    return tden.SDEs(pos=TorchVP(), node_orientations=TorchSO3(
        **SO3, cache_dir=str(tmp_path_factory.mktemp("so3")), device="cpu"))


def _toy_model(pos, rot, t):
    """A smooth stand-in score model: pulls positions toward 0.5 nm and
    leaves the rotations' score at zero."""
    return -(pos - 0.5), torch.zeros_like(pos)


def test_make_denoiser_offers_the_jax_samplers():
    assert sorted(tbd.DENOISER_DEFAULTS) == sorted(jbd.DENOISER_DEFAULTS)
    assert sorted(tbd.DENOISER_DEFAULTS) == ["dpm", "dpm_2m", "dpm_fast", "euler_maruyama", "heun"]
    for name in tbd.DENOISER_DEFAULTS:
        got, want = tbd.make_denoiser(name), jbd.make_denoiser(name)
        assert got.func.__name__ == want.func.__name__, name
        assert got.keywords == want.keywords, name
    assert tbd.make_denoiser("heun").func is tden.heun
    assert tbd.make_denoiser("euler_maruyama").func is tden.euler_maruyama


@pytest.mark.parametrize("path", DENOISER_YAMLS, ids=lambda p: p.stem)
def test_reference_denoiser_yamls_instantiate_in_the_port(path):
    cfg = yaml.safe_load(path.read_text())
    got, want = tbd.make_denoiser(cfg), jbd.make_denoiser(cfg)
    assert got.func is getattr(tden, want.func.__name__)
    assert got.keywords == want.keywords


def test_finetune_registry_holds_the_jax_recorders_and_step_counts():
    assert sorted(ttr.FINETUNE_DENOISERS) == sorted(jtr.FINETUNE_DENOISERS)
    for name, want in jtr.FINETUNE_DENOISERS.items():
        got = dict(ttr.FINETUNE_DENOISERS[name])
        want = dict(want)
        assert got.pop("fn").__name__ == want.pop("fn").__name__ == name
        assert got == want, name
    assert ttr.FINETUNE_DENOISERS["sde_dpm_solver_finetune"]["num_steps"] == 50


@pytest.mark.parametrize("sampler", ["euler_maruyama", "heun"])
def test_public_samplers_draw_prior_then_each_steps_normals(sdes, sampler):
    B, L, steps = 3, 5, 4
    fn = partial(getattr(tden, sampler), num_steps=steps)
    runs = [fn(torch.Generator().manual_seed(5), sdes, _toy_model, B, L) for _ in range(2)]
    other = fn(torch.Generator().manual_seed(6), sdes, _toy_model, B, L)
    gen = torch.Generator().manual_seed(5)
    pos0, rot0 = tden._prior(gen, sdes, B, L)
    z = [torch.randn((B, L, 3), generator=gen) for _ in range(2 * steps)]
    replay = tden.solve_from(fn, sdes, _toy_model, pos0, rot0,
                             (torch.stack(z[0::2]), torch.stack(z[1::2])))
    for a, b, c in zip(runs[0], runs[1], replay):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert not torch.equal(runs[0][0], other[0])
    assert runs[0][0].shape == (B, L, 3) and runs[0][1].shape == (B, L, 3, 3)


def test_sde_dpm_recorder_draws_only_its_prior(sdes):
    B, L, steps = 3, 5, 4

    def control(pos, rot, t):
        return 0.01 * pos, torch.full_like(pos, 0.02)

    runs = [tden.sde_dpm_solver_finetune(torch.Generator().manual_seed(5), sdes, _toy_model, control,
                                         B, L, num_steps=steps) for _ in range(2)]
    gen = torch.Generator().manual_seed(5)
    pos0, rot0 = tden._prior(gen, sdes, B, L)
    replay = tden._sde_dpm_solver_finetune_loop(sdes, _toy_model, control, pos0, rot0, steps, 0.99,
                                                0.001, torch.float32)
    for path in (runs[1], replay):
        for a, b in zip(runs[0][:3], path[:3]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for k in ("pos", "node_orientations"):
            torch.testing.assert_close(runs[0].us[k], path.us[k], rtol=0, atol=0)
            torch.testing.assert_close(runs[0].dWs[k], path.dWs[k], rtol=0, atol=0)
    path = runs[0]
    assert path.pos_path.shape == (steps + 1, B, L, 3) and path.rot_path.shape == (steps + 1, B, L, 3, 3)
    assert path.us["pos"].shape == path.dWs["node_orientations"].shape == (steps, B, L, 3)
    torch.testing.assert_close(path.us["node_orientations"], torch.full((steps, B, L, 3), 0.02))
    assert all(torch.isfinite(x).all() for x in (path.pos_path, path.rot_path, *path.dWs.values()))


def test_solve_from_refuses_what_it_cannot_run(sdes):
    pos, rot = tden._prior(torch.Generator().manual_seed(0), sdes, 2, 3)
    with pytest.raises(ValueError, match="draws noise at every step"):
        tden.solve_from(partial(tden.heun, num_steps=2), sdes, _toy_model, pos, rot)
    with pytest.raises(ValueError, match="no solver loop"):
        tden.solve_from(partial(tden.sde_dpm_solver_finetune, num_steps=2), sdes, _toy_model, pos, rot)


@pytest.fixture
def tiny_ckpt(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    with np.load(REPO / "tests/test_data/golden_dig/state_dict.npz") as sd:
        torch.save({k: torch.from_numpy(np.asarray(sd[k])) for k in sd}, d / "checkpoint.ckpt")
    (d / "config.yaml").write_text(TINY_SAMPLE_CONFIG)
    return d / "checkpoint.ckpt"


@pytest.mark.parametrize("denoiser", ["heun", "euler_maruyama"])
def test_sample_cli_runs_the_stochastic_samplers_on_the_cpu(tmp_path, monkeypatch, tiny_ckpt, denoiser):
    monkeypatch.setenv("HOME", str(tmp_path))
    calls = []
    real = tden._LOOPS[getattr(tden, denoiser)]
    monkeypatch.setattr(tden, f"_{denoiser}_loop", lambda *a, **k: calls.append(a[5]) or real(*a, **k))
    out = tmp_path / "out"
    sample_cli.main([
        "--sequence", "GYDPETGTWG", "--num_samples", "2", "--output_dir", str(out),
        "--ckpt_path", str(tiny_ckpt), "--denoiser", denoiser, "--embeds_backend", "dummy",
        "--cache_embeds_dir", str(tmp_path / "embeds"), "--so3_cache_dir", str(tmp_path / "so3"),
        "--exact_batch_size", "2", "--no-filter_samples", "--device", "cpu",
    ])
    # The CLI's denoiser ran its loop once, at the registry's step count.
    assert calls == [tbd.DENOISER_DEFAULTS[denoiser]["num_steps"]]
    names = sorted(p.name for p in out.iterdir())
    assert "batch_0000000_0000002.npz" in names and "topology.pdb" in names
    with np.load(out / "batch_0000000_0000002.npz") as d:
        assert d["pos"].shape == (2, 10, 3) and np.isfinite(d["pos"]).all()
        assert np.isfinite(d["node_orientations"]).all()


def _finetune_inputs(tmp_path):
    lines = (ASSETS / "reference_h" / "GRB2_SH3_high_confidence.csv").read_text().splitlines()
    (tmp_path / "grb2.csv").write_text("\n".join(lines[:3]) + "\n")
    (tmp_path / "config.yaml").write_text(TINY_FINETUNE_CONFIG)
    score = init_weights(TorchDiG(num_layers=1, dim_model=16, dim_pair=8, num_heads=2, dim_hidden=16),
                         torch.Generator().manual_seed(0))
    np.savez(tmp_path / "score.npz", **{k: v.numpy() for k, v in score.state_dict().items()})
    return [
        "--csv_path", str(tmp_path / "grb2.csv"), "--csv_path_val", str(tmp_path / "grb2.csv"),
        "--h_stars_cols", "f_dg_pred", "--h_stars_from_dg",
        "--ckpt_path", str(tmp_path / "score.npz"), "--model_config_path", str(tmp_path / "config.yaml"),
        "--h_func_ref_path", str(ASSETS / "structures" / "2vwf_trimmed_SH3.pdb"),
        "--batch_size", "3", "--num_epochs", "1", "--output_dir", str(tmp_path / "out"),
        "--cache_embeds_dir", str(tmp_path / "embeds"), "--embeds_backend", "dummy",
        "--so3_cache_dir", str(tmp_path / "so3"), "--device", "cpu",
    ]


@pytest.mark.parametrize("how", ["denoiser_type", "denoiser_config_path"])
def test_finetune_cli_records_with_sde_dpm_solver_finetune(tmp_path, monkeypatch, how):
    """Two steps of ``sde_dpm_solver_finetune``, named by ``--denoiser_type`` or
    by the reference ``sde_dpm_finetune.yaml``: every path on the recorder,
    finite losses, a checkpoint both packages load."""
    calls = []
    real = tden._sde_dpm_solver_finetune_loop
    monkeypatch.setattr(tden, "_sde_dpm_solver_finetune_loop",
                        lambda *a: calls.append(a[5]) or real(*a))
    pick = (["--denoiser_type", "sde_dpm_solver_finetune"] if how == "denoiser_type" else
            ["--denoiser_config_path", str(REPO / "se3diff_tpu/config/denoiser/sde_dpm_finetune.yaml")])
    finetune_cli.main(_finetune_inputs(tmp_path) + pick + ["--num_steps", "2"])
    out = tmp_path / "out"
    # 2 training paths, and 2 validation mutants at epochs 0 and 1.
    assert calls == [2] * 6
    import json

    hist = json.loads((out / "history.json").read_text())
    assert np.isfinite([e["loss"] for e in hist["train"]] + [e["val_loss"] for e in hist["val"]]).all()
    jtr.load_finetune_params(out / "finetune_model.npz")
    back = TorchDiG(**FT_CFG)
    back.load_state_dict(ttr.load_finetune_params(out / "finetune_model.npz"), strict=True)


def test_finetune_cli_refuses_a_sampling_denoiser_yaml(tmp_path):
    heun_yaml = REPO / "se3diff_tpu/config/denoiser/heun.yaml"
    with pytest.raises(SystemExit, match="must name a \\*_finetune path recorder"):
        finetune_cli.main(_finetune_inputs(tmp_path) + ["--denoiser_config_path", str(heun_yaml)])
