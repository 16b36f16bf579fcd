"""Sampling CLI and pipeline of the PyTorch port, on the CPU.

The port's CLI (``--device cpu --embeds_backend dummy``) must write the same
set of output files as the JAX package's CLI on the same arguments, with
the same npz keys and shapes and the same PDB topology records. The weights
and random draws differ between the packages, so coordinates are not
compared here (tests/test_torch_denoise.py compares trajectories from one
prior).
"""

import numpy as np
import pytest
import torch

import se3diff_torch.sample as torch_cli
import se3diff_tpu.sample as jax_cli
from se3diff_torch.sampling.bundle import random_bundle, resolve_device
from se3diff_torch.sampling.pipeline import sample

# Two DPM-Solver-2 steps: the point is the pipeline, not the sampler.
DENOISER_YAML = "_target_: bioemu.denoiser.dpm_solver\nnum_steps: 2\nmax_t: 0.99\nmin_t: 0.001\n"
SMALL = dict(dim_model=64, dim_pair=32, num_layers=1, num_heads=4, dim_hidden=64)


def _cli_args(out, tmp_path):
    cfg = tmp_path / "denoiser.yaml"
    cfg.write_text(DENOISER_YAML)
    return [
        "--sequence", "GYDPETGTWG", "--num_samples", "3", "--output_dir", str(out),
        "--embeds_backend", "dummy", "--cache_embeds_dir", str(tmp_path / "embeds"),
        "--batch_size_100", "200", "--denoiser_config_path", str(cfg), "--no-filter_samples",
    ]


def _records(path):
    """PDB records with the coordinate columns blanked."""
    return [line[:30] + line[54:] for line in path.read_text().splitlines()]


def test_cli_writes_the_same_files_as_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    torch_cli.main(_cli_args(out_t, tmp_path) + ["--device", "cpu"])
    jax_cli.main(_cli_args(out_j, tmp_path))

    names = sorted(p.name for p in out_t.iterdir())
    assert names == sorted(p.name for p in out_j.iterdir())
    assert "topology.pdb" in names and ("samples.xtc" in names or "samples.pdb" in names)
    for npz in out_t.glob("batch_*.npz"):
        with np.load(npz) as a, np.load(out_j / npz.name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            assert np.isfinite(a["pos"]).all() and np.isfinite(a["node_orientations"]).all()
    assert _records(out_t / "topology.pdb") == _records(out_j / "topology.pdb")


def test_cli_on_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the error path needs a CUDA-less host")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        torch_cli.main(_cli_args(tmp_path / "o", tmp_path))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device("cuda")


def test_resume_continues_and_reproduces(tmp_path):
    bundle = random_bundle(SMALL, denoiser="dpm_fast", device="cpu")
    kw = dict(
        sequence="GYDPETGTWG", bundle=bundle, batch_size=2, embeds_backend="dummy",
        cache_embeds_dir=str(tmp_path / "embeds"), filter_samples=False,
    )
    sample(num_samples=2, output_dir=str(tmp_path / "a"), **kw)
    sample(num_samples=4, output_dir=str(tmp_path / "a"), **kw)
    sample(num_samples=4, output_dir=str(tmp_path / "b"), **kw)
    files = sorted(p.name for p in (tmp_path / "a").glob("batch_*.npz"))
    assert files == ["batch_0000000_0000002.npz", "batch_0000002_0000004.npz"]
    for name in files:
        with np.load(tmp_path / "a" / name) as a, np.load(tmp_path / "b" / name) as b:
            np.testing.assert_array_equal(a["pos"], b["pos"])
            np.testing.assert_array_equal(a["node_orientations"], b["node_orientations"])
