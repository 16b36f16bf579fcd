"""The JAX package's remaining public functions in the PyTorch port, each
against its JAX counterpart on the CPU:

* ``sampling.generate_batch`` / ``generate_batch_async``: the batch that
  ``sample`` saves for the same seed, bit for bit (the packages draw
  different random numbers, so against JAX's ``generate_batch`` the keys,
  shapes and dtypes are compared, with and without a length bucket);
* ``sampling.write_structure_outputs``: from the batches a ``sample`` run
  saved, the same ``topology.pdb`` and ``samples.xtc`` (or
  ``samples.pdb``) bytes as that run; against JAX's function on the same
  batches, the same PDB records with coordinates within 2e-3 Angstrom (the
  files print 3 decimals; the frames' f32 rounding may cross one) and the
  same trajectory within 2e-3 nm (the XTC's precision);
* ``struct.get_atom37_from_frames``: atom37 within 1e-4 Angstrom, the same
  mask and aatype;
* ``struct.get_physical_frame_indices``: the same indices on the host and
  on the device path, and the same refusal under ``strict``;
* ``ppft.h_functions.compute_folded_proportion_from_dg``: within 1e-6, and
  the inverse of ``compute_dg``.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ppft import h_functions as th
from se3diff_torch.sampling import generate_batch, generate_batch_async, write_structure_outputs
from se3diff_torch.sampling.bundle import random_bundle
from se3diff_torch.sampling.pipeline import sample
from se3diff_torch.struct import get_atom37_from_frames, get_physical_frame_indices, read_pdb
from se3diff_torch.struct import xtc as txtc
from se3diff_tpu.ppft import h_functions as jh
from se3diff_tpu.sampling import generate_batch as jax_generate_batch
from se3diff_tpu.sampling import write_structure_outputs as jax_write_structure_outputs
from se3diff_tpu.sampling.bundle import random_bundle as jax_random_bundle
from se3diff_tpu.struct import get_atom37_from_frames as jax_get_atom37_from_frames
from se3diff_tpu.struct import get_physical_frame_indices as jax_get_physical_frame_indices

SEQ = "GYDPETGTWG"
SMALL = dict(dim_model=64, dim_pair=32, num_layers=1, num_heads=4, dim_hidden=64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads here: the suite runs several workers on the
    same cores, and oversubscribed OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved_run(tmp_path_factory):
    """A ``sample`` run of 5 structures in batches of 2, no filter."""
    out = tmp_path_factory.mktemp("run")
    bundle = random_bundle(SMALL, denoiser="dpm_fast", device="cpu")
    sample(sequence=SEQ, num_samples=5, output_dir=str(out), bundle=bundle, batch_size=2,
           embeds_backend="dummy", cache_embeds_dir=str(out / "embeds"), filter_samples=False)
    return bundle, out


@pytest.mark.parametrize("bucket", [None, 16])
def test_generate_batch_equals_the_saved_batch(saved_run, bucket):
    bundle, out = saved_run
    from se3diff_torch.sampling.embeds import get_embeds, load_embeds

    single, pair = load_embeds(*get_embeds(SEQ, str(out / "embeds"), backend="dummy"))
    got = generate_batch(bundle, single, pair, seed=2, batch_size=2, length_bucket=bucket)
    with np.load(out / "batch_0000002_0000004.npz") as saved:
        if bucket is None:
            for k in ("pos", "node_orientations"):
                np.testing.assert_array_equal(got[k], saved[k])
        for k in ("pos", "node_orientations"):
            assert got[k].shape == saved[k].shape and got[k].dtype == saved[k].dtype
    pos, rot = generate_batch_async(bundle, single, pair, 2, 2, bucket)
    assert isinstance(pos, torch.Tensor) and pos.shape == (2, len(SEQ), 3)
    np.testing.assert_array_equal(pos.numpy(), got["pos"])

    jbundle = jax_random_bundle(SMALL, denoiser="dpm_fast", length=len(SEQ))
    want = jax_generate_batch(jbundle, single, pair, seed=2, batch_size=2, length_bucket=bucket)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].shape == got[k].shape and want[k].dtype == got[k].dtype, k


def _trajectory(out):
    path = out / "samples.xtc"
    if path.exists():
        return txtc.read_xtc(str(path))[0]
    return read_pdb(str(out / "samples.pdb")).atom37   # the codec is not built


def test_write_structure_outputs_reproduces_the_saved_run(saved_run, tmp_path):
    _, out = saved_run
    names = [p.name for p in out.iterdir() if p.suffix in (".pdb", ".xtc")]
    assert "topology.pdb" in names
    want = {n: (out / n).read_bytes() for n in names}
    again, jax_dir = tmp_path / "again", tmp_path / "jax"
    for d in (again, jax_dir):
        d.mkdir()
        for f in out.glob("batch_*.npz"):
            shutil.copy(f, d / f.name)
    assert write_structure_outputs(again, SEQ, filter_samples=False, device="cpu") == again
    for n, data in want.items():
        assert (again / n).read_bytes() == data, n

    jax_write_structure_outputs(jax_dir, SEQ, filter_samples=False)
    top, jtop = read_pdb(str(again / "topology.pdb")), read_pdb(str(jax_dir / "topology.pdb"))
    np.testing.assert_array_equal(top.aatype, jtop.aatype)
    np.testing.assert_array_equal(top.mask, jtop.mask)
    np.testing.assert_allclose(top.atom37, jtop.atom37, atol=2e-3)
    got_traj, want_traj = _trajectory(again), _trajectory(jax_dir)
    assert got_traj.shape == want_traj.shape
    np.testing.assert_allclose(got_traj, want_traj, atol=2e-3)


REAL = "tests/test_data/samples_example/folding_free_energies/test_1TG0.pdb"


def _frames(rng, n_frames):
    """Frames of a real chain (physical), copied; from frame 2 on each
    residue moved by 0.1 nm noise (unphysical)."""
    from se3diff_torch.struct import frames_from_atom37
    from se3diff_torch.struct.residues import RESTYPES

    struct = read_pdb(REAL)
    pos, rot = frames_from_atom37(struct.atom37.reshape(-1, 37, 3))
    pos = np.repeat(pos[None], n_frames, 0)
    pos[2:] += (rng.standard_normal(pos[2:].shape) * 0.1).astype(np.float32)
    aatype = struct.aatype.reshape(-1)
    return pos, np.repeat(rot[None], n_frames, 0), "".join(RESTYPES[a] for a in aatype)


def test_get_atom37_from_frames_and_physical_indices_match_jax():
    rng = np.random.default_rng(4)
    pos, rot, seq = _frames(rng, 4)
    a37, mask, aatype = get_atom37_from_frames(torch.from_numpy(pos), torch.from_numpy(rot), seq)
    ja37, jmask, jaatype = jax_get_atom37_from_frames(jnp.asarray(pos), jnp.asarray(rot), seq)
    np.testing.assert_allclose(a37.numpy(), np.asarray(ja37), atol=1e-4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(aatype, jaatype)

    mask_np = mask.numpy()
    want = jax_get_physical_frame_indices(np.asarray(ja37), np.asarray(jmask))
    for device in (False, True):
        got = get_physical_frame_indices(a37.numpy() if not device else a37, mask_np,
                                         device=device)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jax_get_physical_frame_indices(np.asarray(ja37), np.asarray(jmask), device=device))
    np.testing.assert_array_equal(want, [0, 1])   # 1 A of noise breaks the chain
    with pytest.raises(AssertionError):
        jax_get_physical_frame_indices(np.asarray(ja37)[2:], np.asarray(jmask), strict=True)
    with pytest.raises(ValueError, match="unphysical"):
        get_physical_frame_indices(a37.numpy()[2:], mask_np, strict=True)


def test_compute_folded_proportion_from_dg_matches_jax():
    dg = np.linspace(-4.0, 4.0, 17).astype(np.float32)
    for temperature in (298.0, 310.0):
        got = th.compute_folded_proportion_from_dg(torch.from_numpy(dg), temperature)
        want = jh.compute_folded_proportion_from_dg(jnp.asarray(dg), temperature)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    p = th.compute_folded_proportion_from_dg(torch.tensor(1.3))
    torch.testing.assert_close(th.compute_dg(p[None]), torch.tensor(1.3), atol=1e-4, rtol=0)
