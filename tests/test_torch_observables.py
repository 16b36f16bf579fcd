"""The port's analysis observables and mmCIF I/O against the JAX package.

``se3diff_torch.ppft.observables`` and ``se3diff_torch.struct.cif`` are held
against ``se3diff_tpu.ppft.observables`` and ``se3diff_tpu.struct.cif`` on the
CPU, on the repository's GRB2-SH3 and PSD95-PDZ3 references and seeded noisy
copies of them (numpy draws, f32; JAX's outputs cast to f32):

* the contact map exactly; contact scores and FNC at atol 1e-5;
* the Kabsch alignment, batched and not, with and without weights, and on a
  reflected input, at atol 1e-4 nm;
* the binary h-functions exactly, the continuous ones at 1e-5 (FNC) and
  1e-4 nm (RMSD);
* h* from both CSVs at rtol 1e-6;
* ``load_ref`` on a ``.cif`` that JAX wrote, against the ``.pdb``, at 1e-4 nm;
  ``to_modelcif`` text equal to JAX's, and parsed back.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch import struct as tstruct
from se3diff_torch.ppft import observables as tobs
from se3diff_tpu import struct as jstruct
from se3diff_tpu.ppft import observables as jobs

ASSETS = Path(__file__).parent.parent / "assets"
REFS = {
    "grb2_sh3": str(ASSETS / "structures" / "2vwf_trimmed_SH3.pdb"),
    "psd95_pdz3": str(ASSETS / "structures" / "1be9_trimmed.pdb"),
}
CSVS = ["GRB2_SH3_high_confidence.csv", "PSD95_PDZ3_high_confidence.csv"]
# Noise (nm) of the batch's copies: folded, near-folded and unfolded rows.
NOISE = np.array([0.0, 0.01, 0.03, 0.06, 0.1, 0.2, 0.4, 0.8], np.float32)


def _noisy(ref_nm, rng, copies=2):
    """``[len(NOISE) * copies, L, 3]`` f32: the reference with Gaussian noise,
    each copy rotated at random and shifted."""
    out = []
    for _ in range(copies):
        for s in NOISE:
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            x = (ref_nm + rng.standard_normal(ref_nm.shape) * s) @ q.T + rng.standard_normal(3)
            out.append(x)
    return np.stack(out).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _j(x):
    return np.asarray(x, np.float32)


def test_every_public_name_of_the_jax_module_is_ported():
    names = {n for n, v in vars(jobs).items() if not n.startswith("_")
             and (getattr(v, "__module__", None) == jobs.__name__
                  or isinstance(v, (int, float, tuple, slice)) or n == "h_star_for_grb2_sh3")}
    names -= {"annotations"}
    assert names >= {"FNCSettings", "compute_h_binary", "LOOP_REGION", "SH3_INTERFACE_RESIDUES"}
    missing = sorted(n for n in names if not hasattr(tobs, n))
    assert not missing, missing
    for n in ("from_cif_string", "read_cif", "to_modelcif", "write_modelcif"):
        assert n in tstruct.__all__ and n in jstruct.__all__
    assert tobs.FNCSettings() == tobs.FNCSettings(**vars(jobs.FNCSettings()))
    for n in ("PROTEIN_FOLDED_Q_THRESHOLD", "LOOP_FOLDED_RMSD_NM", "LOOP_REGION",
              "SH3_INTERFACE_RESIDUES"):
        assert getattr(tobs, n) == getattr(jobs, n)


@pytest.mark.parametrize("name", sorted(REFS))
def test_reference_contact_map_is_jax_s(name):
    ref_ang = tobs.load_ref(REFS[name]) * 10.0
    mask, dist = tobs.reference_contact_map(ref_ang)
    jmask, jdist = jobs.reference_contact_map(ref_ang)
    assert mask.dtype == bool and dist.dtype == np.float32
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(dist, jdist)
    assert 0 < mask.sum() < mask.size


@pytest.mark.parametrize("name", sorted(REFS))
def test_contact_score_and_fnc_match_jax(name, rng):
    ref_nm = tobs.load_ref(REFS[name])
    pos = _noisy(ref_nm, rng)
    mask, dist = tobs.reference_contact_map(ref_nm * 10.0)
    got = tobs.contact_score(_t(pos * 10.0), _t(dist), torch.from_numpy(mask))
    want = jobs.contact_score(jnp.asarray(pos * 10.0), jnp.asarray(dist), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), _j(want), atol=1e-5, rtol=0)
    fnc = tobs.get_fnc_from_coords(_t(pos * 10.0), ref_nm * 10.0)
    jfnc = jobs.get_fnc_from_coords(jnp.asarray(pos * 10.0), ref_nm * 10.0)
    np.testing.assert_allclose(fnc.numpy(), _j(jfnc), atol=1e-5, rtol=0)
    assert fnc.dtype == torch.float32 and fnc.shape == (len(pos),)
    assert float(fnc.min()) < jobs.PROTEIN_FOLDED_Q_THRESHOLD < float(fnc.max())


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
@pytest.mark.parametrize("reflected", [False, True], ids=["proper", "reflected"])
def test_weighted_rigid_align_matches_jax(batched, weighted, reflected, rng):
    ref = tobs.load_ref(REFS["grb2_sh3"])
    pos = _noisy(ref, rng, copies=1)
    if reflected:
        pos = pos * np.array([-1.0, 1.0, 1.0], np.float32)
    w = rng.uniform(0.1, 2.0, ref.shape[0]).astype(np.float32) if weighted else None
    if batched:
        args = (pos, ref)
    else:
        args = (pos[3], ref)
    got = tobs.weighted_rigid_align(*(_t(a) for a in args), None if w is None else _t(w))
    want = jobs.weighted_rigid_align(*(jnp.asarray(a) for a in args),
                                     None if w is None else jnp.asarray(w))
    assert got.shape == args[0].shape
    np.testing.assert_allclose(got.numpy(), _j(want), atol=1e-4, rtol=0)


def test_weighted_rigid_align_recovers_a_rigid_motion(rng):
    ref = tobs.load_ref(REFS["psd95_pdz3"])
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.linalg.det(q))
    moved = (ref @ q.T + np.array([1.0, -2.0, 0.5])).astype(np.float32)
    got = tobs.weighted_rigid_align(_t(moved)[None], _t(ref))[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def _row_near_threshold(raw):
    return (np.abs(raw[:, 0] - jobs.PROTEIN_FOLDED_Q_THRESHOLD) < 1e-4) | (
        np.abs(raw[:, 1] - jobs.LOOP_FOLDED_RMSD_NM) < 1e-4)


@pytest.mark.parametrize("name", sorted(REFS))
def test_h_functions_match_jax(name, rng):
    path = REFS[name]
    pos = _noisy(tobs.load_ref(path), rng)
    raw = tobs.compute_h_raw(_t(pos), path).numpy()
    jraw = _j(jobs.compute_h_raw(jnp.asarray(pos), path))
    np.testing.assert_allclose(raw[:, 0], jraw[:, 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(raw[:, 1], jraw[:, 1], atol=1e-4, rtol=0)

    wrapper = {"grb2_sh3": "compute_h_for_grb2_sh3", "psd95_pdz3": "compute_h_for_psd95_pdz3"}[name]
    far = ~_row_near_threshold(jraw)
    assert far.all()
    for got, want in ((tobs.compute_h_binary(_t(pos), path), jobs.compute_h_binary(jnp.asarray(pos), path)),
                      (getattr(tobs, wrapper)(_t(pos), None, path),
                       getattr(jobs, wrapper)(jnp.asarray(pos), None, path))):
        assert got.dtype == torch.float32 and got.shape == (len(pos), 2)
        np.testing.assert_array_equal(got.numpy()[far], _j(want)[far])
    binary = tobs.compute_h_binary(_t(pos), path).numpy()
    assert binary[0].tolist() == [1.0, 1.0] and binary[:, 0].min() == 0.0


def test_grb2_sh3_raw_matches_jax(rng):
    path = REFS["grb2_sh3"]
    pos = _noisy(tobs.load_ref(path), rng)
    got = tobs.compute_h_for_grb2_sh3_raw(_t(pos), None, path).numpy()
    want = _j(jobs.compute_h_for_grb2_sh3_raw(jnp.asarray(pos), None, path))
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-4, rtol=0)
    assert got[0, 1] < 1e-4  # the reference itself, aligned on the interface


@pytest.mark.parametrize("csv_name", CSVS)
def test_h_star_from_csv_matches_jax(csv_name):
    path = str(ASSETS / "reference_h" / csv_name)
    try:
        jseqs, jh = jobs.h_star_from_csv(path)
    except KeyError as e:
        # A mutant scan without a sequence column: both packages refuse it.
        with pytest.raises(KeyError, match=str(e.args[0])):
            tobs.h_star_from_csv(path)
        return
    seqs, h = tobs.h_star_for_grb2_sh3(path)
    assert seqs == jseqs and len(seqs) > 100
    assert h.dtype == np.float32 and h.shape == (len(seqs), 2)
    np.testing.assert_allclose(h, jh, rtol=1e-6, atol=0)


def test_load_ref_reads_a_cif_the_jax_package_wrote(tmp_path):
    pdb = REFS["grb2_sh3"]
    cif = tmp_path / "sh3.cif"
    jstruct.write_modelcif(jstruct.read_pdb(pdb), str(cif))
    got = tobs.load_ref(str(cif))
    np.testing.assert_allclose(got, tobs.load_ref(pdb), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, jobs.load_ref(str(cif)), atol=0, rtol=0)
    with pytest.raises(ValueError, match="cif or .pdb"):
        tobs.load_ref(str(tmp_path / "sh3.xyz"))


@pytest.mark.parametrize("name", sorted(REFS))
def test_to_modelcif_text_is_jax_s_and_parses_back(name, rng):
    s = tstruct.read_pdb(REFS[name])
    models = np.concatenate([s.atom37, s.atom37 + rng.standard_normal(s.atom37.shape).astype(np.float32)])
    bfac = rng.uniform(20.0, 90.0, s.num_residues).astype(np.float32)
    port = tstruct.Structure(atom37=models, mask=s.mask, aatype=s.aatype, chain_id="B",
                             bfactor=bfac, resseq=s.resseq)
    jax_s = jstruct.Structure(atom37=models, mask=s.mask, aatype=s.aatype, chain_id="B",
                              bfactor=bfac, resseq=s.resseq)
    text = tstruct.to_modelcif(port)
    assert text == jstruct.to_modelcif(jax_s)
    back = tstruct.from_cif_string(text)
    assert back.num_models == 2 and back.chain_id == "B"
    np.testing.assert_array_equal(back.aatype, s.aatype)
    np.testing.assert_array_equal(back.mask, s.mask)
    np.testing.assert_array_equal(back.resseq, s.resseq)
    np.testing.assert_allclose(back.atom37[:, s.mask], models[:, s.mask], atol=1e-3, rtol=0)
