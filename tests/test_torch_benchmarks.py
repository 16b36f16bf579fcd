"""The benchmark suite of the PyTorch port against the JAX package's.

Both packages' ``run_benchmarks`` run the seven benchmarks, with the same
arguments (filtering on, no plots), on the reference's own sample fixture
(``tests/test_data/samples_example/``) cut to its smallest systems: the
whole fixture takes some five minutes of CPU in the JAX package, which the
test suite cannot spend. ``chip_smoke.py`` phase 22 runs the port on the
whole fixture. The fixture holds no ``multiconf_oodval`` samples, so both
packages skip that benchmark.

Both stacks compute in float64 numpy, so ``benchmark_metrics.json``, the
``summary.json`` and ``filter_statistics.json`` files, every npz array and
every CSV cell agree at 1e-12 relative (NaN where NaN). The port on the
whole ood60 fixture meets the reference's own recorded values, as the JAX
package's ``tests/test_bench_real_samples.py`` holds it.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from se3diff_torch.benchmarks import align as talign
from se3diff_torch.benchmarks import cli as tcli
from se3diff_torch.benchmarks import core as tcore
from se3diff_tpu.benchmarks import align as jalign
from se3diff_tpu.benchmarks import cli as jcli
from se3diff_tpu.benchmarks import core as jcore

REPO = Path(__file__).resolve().parent.parent
SAMPLES = REPO / "tests" / "test_data" / "samples_example"
RTOL = 1e-12
# Systems of each fixture directory kept, smallest by residue count first:
# ood60's four smallest files (two test cases, one sampled twice), the
# crypticpocket pair the JAX tests split into holo and apo, and so on.
KEEP = {"multiconf_ood60": 4, "multiconf_domainmotion": 2, "multiconf_crypticpocket": 2,
        "singleconf_localunfolding": 3, "folding_free_energies": 2, "md_emulation": 1}


def _n_residues(pdb: Path) -> int:
    return sum(1 for line in pdb.read_text().splitlines() if line.startswith("ATOM") and line[12:16] == " CA ")


@pytest.fixture(scope="module")
def fixture_subset(tmp_path_factory) -> Path:
    """Links to the kept systems' pdb + xtc pairs, one directory a benchmark."""
    root = tmp_path_factory.mktemp("samples")
    for name, k in KEEP.items():
        d = root / name
        d.mkdir()
        pdbs = sorted((SAMPLES / name).glob("*.pdb"), key=lambda p: (_n_residues(p), p.name))[:k]
        for pdb in pdbs:
            for f in (pdb, pdb.with_suffix(".xtc")):
                (d / f.name).symlink_to(f)
    return root


@pytest.fixture(scope="module")
def both_runs(fixture_subset, tmp_path_factory):
    """Each package's ``run_benchmarks`` over the seven benchmarks, once."""
    out = {}
    for pkg, run, bms in (("jax", jcli.run_benchmarks, jcore.ALL_BENCHMARKS),
                          ("torch", tcli.run_benchmarks, tcore.ALL_BENCHMARKS)):
        d = tmp_path_factory.mktemp(pkg)
        agg = run(bms, samples_dir=str(fixture_subset), output_dir=str(d),
                  skip_filtering=False, plot=False)
        out[pkg] = (agg, d)
    return out


def _close(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _close(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if math.isnan(a):
            assert math.isnan(b), where
        else:
            assert b == pytest.approx(a, rel=RTOL, abs=0.0), where
    else:
        assert a == b, where


def _csv_cell_close(a: str, b: str, where: str):
    try:
        x, y = float(a), float(b)
    except ValueError:
        assert a == b, where
        return
    if math.isnan(x):
        assert math.isnan(y), where
    else:
        assert y == pytest.approx(x, rel=RTOL, abs=0.0), where


def test_seven_benchmarks_agree_with_jax(both_runs):
    (j_agg, j_dir), (t_agg, t_dir) = both_runs["jax"], both_runs["torch"]
    ran = {bm.value for bm in tcore.ALL_BENCHMARKS} - {"multiconf_oodval"}
    assert set(t_agg) == ran, sorted(t_agg)
    _close(j_agg, t_agg, "aggregate")
    _close(json.loads((j_dir / "benchmark_metrics.json").read_text()),
           json.loads((t_dir / "benchmark_metrics.json").read_text()), "benchmark_metrics.json")
    j_files = sorted(p.relative_to(j_dir) for p in j_dir.rglob("*") if p.is_file())
    t_files = sorted(p.relative_to(t_dir) for p in t_dir.rglob("*") if p.is_file())
    assert j_files == t_files
    compared = set()
    for rel in t_files:
        a, b = j_dir / rel, t_dir / rel
        if rel.suffix == ".json":
            _close(json.loads(a.read_text()), json.loads(b.read_text()), str(rel))
        elif rel.suffix == ".npz":
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files), rel
                for k in x.files:
                    np.testing.assert_allclose(y[k], x[k], rtol=RTOL, atol=0, equal_nan=True,
                                               err_msg=f"{rel}:{k}")
        elif rel.suffix == ".csv":
            la, lb = a.read_text().splitlines(), b.read_text().splitlines()
            assert la[0] == lb[0] and len(la) == len(lb), rel
            for i, (ra, rb) in enumerate(zip(la[1:], lb[1:])):
                ca, cb = ra.split(","), rb.split(",")
                assert len(ca) == len(cb), (rel, i)
                for x, y in zip(ca, cb):
                    _csv_cell_close(x, y, f"{rel} row {i}")
        else:
            continue
        compared.add(rel.suffix)
    assert compared == {".json", ".npz", ".csv"}, compared


def test_results_h5_written_last_when_h5py_imports(both_runs):
    pytest.importorskip("h5py")
    _, t_dir = both_runs["torch"]
    for name in ("multiconf_ood60", "multiconf_domainmotion", "singleconf_localunfolding"):
        assert (t_dir / name / "results.h5").exists(), name


def test_reference_recorded_values_ood60():
    """The reference's recorded expectations on its whole ood60 fixture
    (tests/test_multiconf_evaluator.py:16,100-105 there), held as the JAX
    package's tests/test_bench_real_samples.py holds them."""
    from se3diff_torch.benchmarks.multiconf import MetricType, coverage, evaluate_multiconf, k_recall
    from se3diff_torch.benchmarks.samples import IndexedSamples, find_samples_in_dir

    bm = tcore.Benchmark.MULTICONF_OOD60
    indexed = IndexedSamples.from_benchmark(bm, find_samples_in_dir(SAMPLES / bm.value))
    asset = Path(bm.asset_dir)
    evals = evaluate_multiconf(
        indexed, references_dir=str(asset / "reference"), metric_types=[MetricType.RMSD],
        references_localresidinfo_dir=str(asset / "local_residinfo"),
    )
    res = {tc: e.metrics_against_references[MetricType.RMSD] for tc, e in evals.items()}
    _, cov = coverage(res, MetricType.RMSD)
    assert cov[-1] == pytest.approx(0.8157894736842105, abs=1e-12)
    assert k_recall(res, MetricType.RMSD, k=1)["E1C7U0"] == pytest.approx(6.0333076, rel=0.01)


def test_specs_equal_jax_row_for_row(tmp_path):
    want = jcore.benchmark_specs_frame()
    got = tcore.benchmark_specs_frame()
    assert len(got) == len(want) == 292
    for row, (_, ref) in zip(got, want.iterrows()):
        assert row == {c: ref[c] for c in tcore.SPECS_COLUMNS}
    tcli.main(["specs", "--output_csv", str(tmp_path / "t.csv")])
    jcli.main(["specs", "--output_csv", str(tmp_path / "j.csv")])
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_native_tm_score_and_kabsch_match_jax():
    assert talign._load_tmlib() is not None, "native/libtmscore.so did not load"
    rng = np.random.default_rng(0)
    target = rng.standard_normal((40, 3)) * 5.0
    frames = target[None] + rng.standard_normal((6, 40, 3)) * np.array([0.2, 1.0, 2.0, 4.0, 8.0, 16.0])[:, None, None]
    np.testing.assert_array_equal(talign.tm_score_fixed_pairing_batch(frames, target),
                                  jalign.tm_score_fixed_pairing_batch(frames, target))
    np.testing.assert_array_equal(talign.rmsd_optimal_native(frames, target),
                                  jalign.rmsd_optimal_native(frames, target))
    for f in frames:
        for got, want in zip(talign.kabsch_rotation(f, target), jalign.kabsch_rotation(f, target)):
            np.testing.assert_array_equal(got, want)
        assert talign.tm_score_fixed_pairing(f, target) == jalign.tm_score_fixed_pairing(f, target)


@pytest.mark.parametrize("system", [
    "multiconf_domainmotion/P67701_3dbdd067", "multiconf_ood60/Q2FYI5_2955f95d_seed0",
    "singleconf_localunfolding/P09391_f7c150e5_seed0",
])
def test_array_metrics_equal_jax_loops(system):
    """The port's DSSP, contact pairs and mismatched-contact counts are array
    operations where JAX's metrics.py loops; booleans and sums of 0/1, so
    equal bit for bit."""
    from se3diff_torch.benchmarks import metrics as tm
    from se3diff_torch.benchmarks.trajectory import load_sample_traj
    from se3diff_tpu.benchmarks import metrics as jm

    pdb = SAMPLES / f"{system}.pdb"
    traj = load_sample_traj(str(pdb.with_suffix(".xtc")), str(pdb))
    ref = load_sample_traj(str(pdb.with_suffix(".xtc")), str(pdb), np.array([0]))
    np.testing.assert_array_equal(tm.dssp_simplified(traj), jm.dssp_simplified(traj))
    pairs = tm.matching_resids(ref, traj)
    assert pairs == jm.matching_resids(ref, traj)
    np.testing.assert_array_equal(tm.contact_distances(ref, traj, pairs),
                                  jm.contact_distances(ref, traj, pairs))
    resids = [p[0] for p in pairs]
    ref_pairs = [(a, b) for a in resids[: len(resids) // 3] for b in resids[len(resids) // 2:]]
    for kw in ({}, dict(reference_resid_pairs=ref_pairs, exclude_n_neighbours=3)):
        for got, want in zip(tm._contact_maps(ref, traj, pairs, **kw), jm._contact_maps(ref, traj, pairs, **kw)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tm.fraction_native_contacts(ref, traj, pairs, **kw),
                                      jm.fraction_native_contacts(ref, traj, pairs, **kw))


def test_port_samples_are_found_and_scored(tmp_path, monkeypatch):
    """The port's sample CLI output (``topology.pdb`` + ``samples.xtc``) for
    md_emulation's cath1_1bl0A02, joined by sequence and scored."""
    import se3diff_torch.sample as sample_cli
    from se3diff_torch.benchmarks.samples import IndexedSamples, find_samples_in_dir

    monkeypatch.setenv("HOME", str(tmp_path))
    bm = tcore.Benchmark.MD_EMULATION
    seq = tcore.rows_where(bm.metadata, "test_case", "cath1_1bl0A02")[0]["sequence"]
    denoiser = tmp_path / "denoiser.yaml"
    denoiser.write_text("_target_: bioemu.denoiser.dpm_solver\nnum_steps: 2\nmax_t: 0.99\nmin_t: 0.001\n")
    samples = tmp_path / "samples" / "cath1_1bl0A02"
    sample_cli.main([
        "--sequence", seq, "--num_samples", "3", "--output_dir", str(samples),
        "--embeds_backend", "dummy", "--cache_embeds_dir", str(tmp_path / "embeds"),
        "--denoiser_config_path", str(denoiser), "--no-filter_samples", "--device", "cpu",
    ])
    found = find_samples_in_dir(tmp_path / "samples")
    assert [Path(s.topology_file).name for s in found] == ["topology.pdb"]
    indexed = IndexedSamples.from_benchmark(bm, found)
    assert list(indexed.test_case_to_sequencesamples) == ["cath1_1bl0A02"]
    agg = tcli.run_benchmarks([bm], samples_dir=str(tmp_path / "samples"),
                              output_dir=str(tmp_path / "out"), skip_filtering=True, plot=False)
    vals = agg["md_emulation"]
    assert set(vals) == {"mae", "rmse", "coverage"}
    assert all(np.isfinite(v) or np.isnan(v) for v in vals.values())


def test_new_modules_import_no_jax_nor_pandas():
    code = (
        "import sys\n"
        "import se3diff_torch.benchmarks, se3diff_torch.benchmarks.cli, se3diff_torch.benchmarks.plots\n"
        "import se3diff_torch.relax, se3diff_torch.sidechain_relax, se3diff_torch.utils\n"
        "import se3diff_torch.utils.profiling, se3diff_torch.sampling.colabfold_setup\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'se3diff_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
