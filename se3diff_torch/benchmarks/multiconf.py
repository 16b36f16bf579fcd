"""Multiconf + local-unfolding evaluation engine.

Counterpart of `bioemu-benchmarks/bioemu_benchmarks/eval/multiconf/
{evaluate,summary_metrics,unfolding_evaluate}.py`, on our own metric
implementations (no mdtraj/USalign/Biopython).

Counterpart of ``se3diff_tpu/benchmarks/multiconf.py``; the crypticpocket
references table is read with :func:`~se3diff_torch.benchmarks.core.read_csv`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import operator
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from enum import Enum
from glob import glob
from itertools import combinations, product
from typing import Callable

import numpy as np

from se3diff_torch.benchmarks import metrics as M
from se3diff_torch.benchmarks.core import (
    MULTICONF_ASSET_DIR,
    Benchmark,
    BenchmarkResults,
    read_csv,
    rows_where,
)
from se3diff_torch.benchmarks.samples import IndexedSamples, SequenceSample
from se3diff_torch.benchmarks.trajectory import BackboneTraj, load_reference_pdb
from se3diff_torch.benchmarks.align import superpose

logger = logging.getLogger(__name__)

NM2ANGS = 10


class MetricType(str, Enum):
    """(evaluate.py:41-51)"""

    RMSD = "rmsd"
    TMSCORE = "tm-score"
    CONTACT_DISTANCE = "contact-distance"
    LDDT = "lddt"
    DSSP_ACC = "dssp_acc"
    FNC_UNFOLD_U = "fnc_unfold_u"
    FNC_UNFOLD_F = "fnc_unfold_f"


METRIC_OPERATOR_BETTER: dict[MetricType, Callable] = {
    MetricType.RMSD: operator.lt,
    MetricType.TMSCORE: operator.gt,
    MetricType.LDDT: operator.gt,
    MetricType.CONTACT_DISTANCE: operator.lt,
    MetricType.DSSP_ACC: operator.gt,
    MetricType.FNC_UNFOLD_U: operator.lt,
    MetricType.FNC_UNFOLD_F: operator.gt,
}

MULTICONF_METRIC_TYPES = [
    MetricType.RMSD,
    MetricType.TMSCORE,
    MetricType.LDDT,
    MetricType.CONTACT_DISTANCE,
    MetricType.DSSP_ACC,
]

# Coverage threshold grids (summary_metrics.py:14-31).
METRICS_MIN_VAL = {m: 0.0 for m in MetricType}
METRICS_MAX_VAL = {
    MetricType.RMSD: 10.0,
    MetricType.TMSCORE: 1.0,
    MetricType.LDDT: 1.0,
    MetricType.CONTACT_DISTANCE: 10.0,
    MetricType.DSSP_ACC: 1.0,
    MetricType.FNC_UNFOLD_U: 1.0,
    MetricType.FNC_UNFOLD_F: 1.0,
}

# Success thresholds for headline coverage numbers (plot.py:21-29,
# results.py:20-22; crypticpocket RMSD uses 1.5 A).
METRICS_SUCCESS_THRESHOLD = {
    MetricType.RMSD: 3.0,
    MetricType.TMSCORE: 0.75,
    MetricType.LDDT: 0.75,
    MetricType.DSSP_ACC: 0.75,
    MetricType.FNC_UNFOLD_U: 0.3,
    MetricType.FNC_UNFOLD_F: 0.7,
}
BENCHMARK_SPECIFIC_SUCCESS_THRESHOLDS = {
    Benchmark.MULTICONF_CRYPTICPOCKET: {MetricType.RMSD: 1.5},
}


@dataclass
class LocalResidInfo:
    """Alignment/metric residue ranges from JSON (evaluate.py:66-124)."""

    alignment_resid_ranges: list | None
    metric_resid_ranges: list
    n_residues: int
    context_resid_ranges: list | None = None  # present in some JSONs; unused

    @classmethod
    def from_json(cls, json_file, n_residues: int) -> "LocalResidInfo":
        with open(json_file) as fh:
            d = json.load(fh)
        return cls(n_residues=n_residues, **d)

    def _explicit(self, ranges: list) -> list[int]:
        out: list[int] = []
        for r in ranges:
            b = 1 if r[0] is None else int(r[0])
            e = self.n_residues if r[1] is None else int(r[1])
            e = min(e, self.n_residues)
            out.extend(range(b, e + 1))
        return out

    def __post_init__(self):
        self.alignment_resids = (
            self._explicit(self.alignment_resid_ranges)
            if self.alignment_resid_ranges is not None
            else []
        )
        self.metric_resids = self._explicit(self.metric_resid_ranges)


@dataclass
class ClosestSample:
    """(evaluate.py:127-154)"""

    sequence_sample: SequenceSample
    frame_idx: int
    metric_type: MetricType
    metric_value: float
    reference_path: str

    def save_to_pdb(self, test_case: str, closest_dir) -> None:
        from se3diff_torch.struct.pdb import read_pdb, write_pdb, Structure

        dirpath = os.path.join(closest_dir, test_case, self.metric_type.value)
        os.makedirs(dirpath, exist_ok=True)
        name = os.path.splitext(os.path.basename(self.reference_path))[0]
        traj = self.sequence_sample.get_traj()
        frame = traj.coords[self.frame_idx]  # [R, 4, 3]
        struct = read_pdb(self.sequence_sample.topology_file)
        # Write backbone-only structure for the closest frame.
        from se3diff_torch.struct.residues import (
            ATOM37_C, ATOM37_CA, ATOM37_N, ATOM37_O, RESTYPES,
        )

        n = traj.n_residues
        atom37 = np.zeros((1, n, 37, 3), np.float32)
        mask = np.zeros((n, 37), bool)
        for k, a in enumerate([ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_O]):
            atom37[0, :, a] = frame[:, k]
            mask[:, a] = True
        aatype = np.asarray(
            [RESTYPES.index(c) if c in RESTYPES else 0 for c in traj.sequence]
        )
        write_pdb(
            Structure(atom37=atom37, mask=mask, aatype=aatype,
                      resseq=traj.resseq.astype(np.int32)),
            os.path.join(dirpath, f"{name}.pdb"),
        )


@dataclass
class TestCaseResult:
    """(evaluate.py:157-187)"""

    test_case: str
    references_names: list[str] | None
    metrics_between_references: dict | None
    metrics_against_references: dict[MetricType, np.ndarray]
    closest_samples: dict[MetricType, list[ClosestSample]] | None
    topology_ids: np.ndarray | None


def calc_metrics_global(
    ref: BackboneTraj,
    sample: BackboneTraj,
    pairs: list[tuple[int, int]],
    metric_types: list[MetricType],
) -> dict[MetricType, np.ndarray]:
    """(evaluate.py:190-289)"""
    out: dict[MetricType, np.ndarray] = {}
    if MetricType.RMSD in metric_types:
        out[MetricType.RMSD] = M.rmsd(ref, sample, pairs)
    if MetricType.TMSCORE in metric_types:
        out[MetricType.TMSCORE] = M.tm_score(ref, sample, pairs)
    if MetricType.DSSP_ACC in metric_types:
        out[MetricType.DSSP_ACC] = M.dssp_match_accuracy(ref, sample, pairs)
    if MetricType.LDDT in metric_types:
        out[MetricType.LDDT] = M.lddt(ref, sample, pairs)
    if MetricType.CONTACT_DISTANCE in metric_types:
        out[MetricType.CONTACT_DISTANCE] = M.contact_distances(ref, sample, pairs)
    return out


def calc_metrics_local(
    ref: BackboneTraj,
    sample: BackboneTraj,
    pairs: list[tuple[int, int]],
    localresidinfo: LocalResidInfo,
    metric_types: list[MetricType],
) -> dict[MetricType, np.ndarray]:
    """Superpose on the alignment region, measure on the metric region
    (evaluate.py:292-380)."""
    out: dict[MetricType, np.ndarray] = {}

    align_pairs = (
        [p for p in pairs if p[0] in set(localresidinfo.alignment_resids)]
        if localresidinfo.alignment_resid_ranges is not None
        else pairs
    )
    ri = M._indices_for(ref, [p[0] for p in align_pairs])
    si = M._indices_for(sample, [p[1] for p in align_pairs])

    n_at = sample.n_residues * 4
    sample_flat = sample.coords.reshape(sample.n_frames, n_at, 3)
    fit_sample = (si[:, None] * 4 + np.arange(4)[None]).reshape(-1)
    fit_ref = (ri[:, None] * 4 + np.arange(4)[None]).reshape(-1)
    ref_flat = ref.coords[0].reshape(-1, 3)
    # Superpose each sample frame onto the reference using the fit atoms.
    moved = np.empty_like(sample_flat)
    from se3diff_torch.benchmarks.align import kabsch_rotation

    for f in range(sample.n_frames):
        R, cP, cQ = kabsch_rotation(sample_flat[f][fit_sample], ref_flat[fit_ref])
        moved[f] = (sample_flat[f] - cP) @ R.T + cQ
    sample_aligned = BackboneTraj(
        moved.reshape(sample.coords.shape), sample.resseq, sample.sequence
    )

    metric_pairs = [p for p in pairs if p[0] in set(localresidinfo.metric_resids)]
    rmi = M._indices_for(ref, [p[0] for p in metric_pairs])
    smi = M._indices_for(sample, [p[1] for p in metric_pairs])

    if MetricType.RMSD in metric_types or MetricType.TMSCORE in metric_types:
        dev = np.sqrt(
            np.sum(
                (sample_aligned.coords[:, smi] - ref.coords[0][None, rmi]) ** 2,
                axis=-1,
            )
        ).reshape(sample.n_frames, -1)  # [F, n_metric_res * 4]
    if MetricType.RMSD in metric_types:
        out[MetricType.RMSD] = dev.mean(axis=-1)
    if MetricType.TMSCORE in metric_types:
        out[MetricType.TMSCORE] = M.tm_score_local(dev)
    if MetricType.DSSP_ACC in metric_types:
        out[MetricType.DSSP_ACC] = M.dssp_match_accuracy(ref, sample_aligned, metric_pairs)
    if MetricType.LDDT in metric_types:
        out[MetricType.LDDT] = M.lddt(ref, sample_aligned, metric_pairs)
    if MetricType.CONTACT_DISTANCE in metric_types:
        out[MetricType.CONTACT_DISTANCE] = M.contact_distances(
            ref, sample_aligned, metric_pairs
        )
    return out


def get_metrics_against_references(
    sample: BackboneTraj,
    refs: list[BackboneTraj],
    metric_types: list[MetricType],
    localresidinfo: LocalResidInfo | None = None,
) -> dict[MetricType, np.ndarray]:
    """[n_frames, n_references] per metric (evaluate.py:383-445)."""
    metrics: dict[MetricType, list[np.ndarray]] = {}
    for ref in refs:
        pairs = M.matching_resids(ref, sample)
        res = (
            calc_metrics_global(ref, sample, pairs, metric_types)
            if localresidinfo is None
            else calc_metrics_local(ref, sample, pairs, localresidinfo, metric_types)
        )
        for mt, val in res.items():
            metrics.setdefault(mt, []).append(val)
    return {mt: np.vstack(vals).T for mt, vals in metrics.items()}


def get_metrics_between_references(
    refs: list[BackboneTraj],
    metric_types: list[MetricType],
    localresidinfo: LocalResidInfo | None = None,
) -> dict[MetricType, dict[tuple[int, int], float]]:
    """(evaluate.py:448-484)"""
    out: dict[MetricType, dict[tuple[int, int], float]] = {}
    for (i, ref_i), (j, ref_j) in combinations(enumerate(refs), 2):
        res = get_metrics_against_references(
            ref_i, [ref_j], metric_types, localresidinfo
        )
        for mt, arr in res.items():
            out.setdefault(mt, {})[(i, j)] = arr[0]
    return out


def evaluate_test_case(
    test_case: str,
    references_dir,
    sequence_samples: list[SequenceSample],
    metric_types: list[MetricType],
    references_localresidinfo_dir=None,
) -> TestCaseResult:
    """(evaluate.py:487-565)"""
    ref_pdbs = sorted(glob(os.path.join(references_dir, test_case, "*.pdb")))
    assert len(ref_pdbs) > 1, f"Not enough references for {test_case}: {ref_pdbs}"
    refs = [load_reference_pdb(p) for p in ref_pdbs]

    localresidinfo = None
    if references_localresidinfo_dir is not None:
        max_resseq = max(int(r.resseq.max()) for r in refs)
        jf = os.path.join(references_localresidinfo_dir, f"{test_case}.json")
        if os.path.exists(jf):
            localresidinfo = LocalResidInfo.from_json(jf, n_residues=max_resseq)
        else:
            logger.warning(
                "Local eval requested for %s but JSON missing; global eval.", test_case
            )

    between = get_metrics_between_references(refs, metric_types, localresidinfo)

    all_metrics: list[dict[MetricType, np.ndarray]] = []
    topology_ids = []
    for top_index, ss in enumerate(sequence_samples):
        sample = ss.get_traj()
        all_metrics.append(
            get_metrics_against_references(sample, refs, metric_types, localresidinfo)
        )
        topology_ids.append(np.full(sample.n_frames, top_index, int))

    flat = {
        mt: np.vstack([m[mt] for m in all_metrics])
        for mt in all_metrics[0].keys()
    }
    topology_ids = np.hstack(topology_ids)

    closest = get_closest_sample_per_reference(
        sequence_samples, flat, ref_pdbs, topology_ids
    )
    return TestCaseResult(
        test_case=test_case,
        references_names=[os.path.basename(p) for p in ref_pdbs],
        metrics_between_references=between,
        metrics_against_references=flat,
        closest_samples=closest,
        topology_ids=topology_ids,
    )


def get_closest_sample_per_reference(
    sequence_samples, metrics_against_references, references, topology_ids
) -> dict[MetricType, list[ClosestSample]]:
    """(evaluate.py:568-628)"""
    out: dict[MetricType, list[ClosestSample]] = {}
    uq = sorted(set(topology_ids))
    frame_idxs = np.hstack([np.arange(np.sum(topology_ids == t)) for t in uq])
    for mt, mar in metrics_against_references.items():
        better = METRIC_OPERATOR_BETTER[mt]
        argbest = np.argmax if better == operator.gt else np.argmin
        best_fun = np.max if better == operator.gt else np.min
        best_idxs = argbest(mar, axis=0)
        out[mt] = [
            ClosestSample(
                sequence_samples[int(topology_ids[bi])],
                frame_idx=int(frame_idxs[bi]),
                metric_type=mt,
                metric_value=float(best_fun(mar[bi, :])),
                reference_path=references[int(argbest(mar[bi, :]))],
            )
            for bi in best_idxs
        ]
    return out


def evaluate_multiconf(
    indexed_samples: IndexedSamples,
    references_dir,
    metric_types: list[MetricType] | None = None,
    references_localresidinfo_dir=None,
    n_jobs: int = 0,
) -> dict[str, TestCaseResult]:
    """(evaluate.py:640-682); n_jobs=0 -> sequential."""
    metric_types = metric_types or [MetricType.RMSD]
    assert set(metric_types).issubset(MULTICONF_METRIC_TYPES)
    items = list(indexed_samples.test_case_to_sequencesamples.items())
    if n_jobs and n_jobs != 1 and len(items) > 1:
        with ProcessPoolExecutor(max_workers=None if n_jobs < 0 else n_jobs) as ex:
            results = list(
                ex.map(
                    _evaluate_one,
                    [
                        (tc, references_dir, sss, metric_types,
                         references_localresidinfo_dir)
                        for tc, sss in items
                    ],
                )
            )
    else:
        results = [
            _evaluate_one((tc, references_dir, sss, metric_types,
                           references_localresidinfo_dir))
            for tc, sss in items
        ]
    return {r.test_case: r for r in results}


def _evaluate_one(args) -> TestCaseResult:
    tc, refd, sss, mts, lrd = args
    logger.info("Evaluating %s", tc)
    return evaluate_test_case(tc, refd, sss, mts, lrd)


# ------------------------------------------------------------------ #
# Local unfolding (unfolding_evaluate.py:20-124)                      #
# ------------------------------------------------------------------ #


def evaluate_singleconf_unfolding_test_case(
    test_case: str,
    references_dir,
    sequence_samples: list[SequenceSample],
    references_localresidinfo_dir,
) -> TestCaseResult:
    ref_pdbs = sorted(glob(os.path.join(references_dir, test_case, "*.pdb")))
    assert len(sequence_samples) == len(ref_pdbs) == 1
    ref = load_reference_pdb(ref_pdbs[0])
    sample = sequence_samples[0].get_traj()
    lri = LocalResidInfo.from_json(
        os.path.join(references_localresidinfo_dir, f"{test_case}.json"),
        n_residues=int(ref.resseq.max()),
    )
    pairs = M.matching_resids(ref, sample)
    folding = set(lri.metric_resids)
    fold_pairs = [p for p in pairs if p[0] in folding]
    rest_pairs = [p for p in pairs if p[0] not in folding]
    ref_pairs = list(combinations([p[0] for p in fold_pairs], 2)) + list(
        product([p[0] for p in fold_pairs], [p[0] for p in rest_pairs])
    )
    assert ref_pairs
    fnc = M.fraction_native_contacts(
        ref, sample, pairs, reference_resid_pairs=ref_pairs, exclude_n_neighbours=3
    )
    metrics = {
        MetricType.FNC_UNFOLD_F: fnc,
        MetricType.FNC_UNFOLD_U: fnc,
    }
    return TestCaseResult(
        test_case=test_case,
        references_names=None,
        metrics_between_references=None,
        metrics_against_references={
            mt: v[:, None] for mt, v in metrics.items()
        },
        closest_samples=None,
        topology_ids=None,
    )


def evaluate_singleconf_unfolding(
    indexed_samples: IndexedSamples,
    references_dir,
    references_localresidinfo_dir,
    n_jobs: int = 0,
) -> dict[str, TestCaseResult]:
    out = {}
    for tc, sss in indexed_samples.test_case_to_sequencesamples.items():
        logger.info("Evaluating %s", tc)
        out[tc] = evaluate_singleconf_unfolding_test_case(
            tc, references_dir, sss, references_localresidinfo_dir
        )
    return out


# ------------------------------------------------------------------ #
# Summary metrics (summary_metrics.py)                                #
# ------------------------------------------------------------------ #


def coverage(
    results: dict[str, np.ndarray], metric_type: MetricType, nsuccess: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """(summary_metrics.py:70-101)"""
    xrange = np.linspace(
        METRICS_MIN_VAL[metric_type], METRICS_MAX_VAL[metric_type], num=100
    )
    better = METRIC_OPERATOR_BETTER[metric_type]
    n_below = np.zeros_like(xrange)
    for x in results.values():
        for j, r in enumerate(xrange):
            C = better(x, r).astype(int).sum(axis=0)
            n_below[j] += np.mean(C >= nsuccess)
    return xrange, n_below / len(results)


def coverage_bootstrap(
    results: dict[str, np.ndarray],
    metric_type: MetricType,
    nsuccess: int = 1,
    nbootstrap: int = 20,
    nsample: int = 1000,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(summary_metrics.py:34-67)"""
    rng = rng or np.random.default_rng()
    curves = []
    for _ in range(nbootstrap):
        resampled = {
            s: x[rng.integers(0, x.shape[0], size=nsample)]
            for s, x in results.items()
        }
        x_range, cov = coverage(resampled, metric_type, nsuccess)
        curves.append(cov)
    return x_range, np.asarray(curves)


def k_recall(
    results: dict[str, np.ndarray], metric_type: MetricType, k: int = 1
) -> dict[str, float]:
    """Mean of the best k values (summary_metrics.py:104-128)."""
    out = {}
    for s, x in results.items():
        xs = np.sort(x, axis=0)
        if METRIC_OPERATOR_BETTER[metric_type] == operator.gt:
            xs = xs[::-1]
        out[s] = float(np.mean(xs[:k]))
    return out


def k_recall_bootstrap(
    results: dict[str, np.ndarray],
    metric_type: MetricType,
    k: int = 1,
    nbootstrap: int = 20,
    nsample: int = 1000,
    rng: np.random.Generator | None = None,
) -> dict[str, tuple[float, float]]:
    """(summary_metrics.py:131-163)"""
    rng = rng or np.random.default_rng()
    acc: dict[str, list[float]] = {s: [] for s in results}
    for _ in range(nbootstrap):
        resampled = {
            s: x[rng.integers(0, x.shape[0], size=nsample)]
            for s, x in results.items()
        }
        for s, v in k_recall(resampled, metric_type, k).items():
            acc[s].append(v)
    return {s: (float(np.mean(v)), float(np.std(v))) for s, v in acc.items()}


def split_holo_apo(result: TestCaseResult) -> tuple[TestCaseResult, TestCaseResult]:
    """(evaluate.py:685-719)"""
    md = read_csv(os.path.join(MULTICONF_ASSET_DIR, "crypticpocket/references.csv"))
    row = rows_where(md, "test_case", result.test_case)[0]
    assert result.references_names is not None
    is_holo = [
        name.split(".pdb")[0] == str(row["holo_pdbidchain"]).upper()
        for name in result.references_names
    ]
    holo_index = int(np.argmax(is_holo))
    apo_index = 1 - holo_index

    def slice_refs(idx):
        r = dataclasses.replace(result)
        r.metrics_against_references = {
            k: v[:, idx : idx + 1] for k, v in result.metrics_against_references.items()
        }
        return r

    return slice_refs(holo_index), slice_refs(apo_index)


@dataclass
class MulticonfResults(BenchmarkResults):
    """(results.py:28-92) — serialized as the reference's H5 contract plus
    npz/json conveniences."""

    per_system: dict[str, TestCaseResult]
    coverage: dict[str, dict[MetricType, tuple[np.ndarray, np.ndarray]]]
    krecall: dict[str, dict[MetricType, dict[str, tuple[float, float]]]]
    benchmark: Benchmark

    def save_to_h5(self, outfile) -> None:
        """Write the reference's hierarchical H5 key set (results.py:43-92)
        so downstream consumers of BioEmu results can read ours:

        - ``coverage_{label}_{metric}/{thresholds,values}``
        - ``krecall_{label}_{metric}/{test_case}`` = [mean, std]
        - ``sample_metrics/{test_case}/{metric}`` (+ ``topology_ids`` for
          multiconf benchmarks)
        - ``reference_metrics/{test_case}/references_names`` and
          ``{metric}_{i}_{j}`` between-reference values
        """
        try:
            import h5py
        except ImportError as exc:  # npz/json outputs remain available
            raise ImportError(
                "h5py is required for the reference-format H5 results file; "
                "install it or use the npz/json outputs"
            ) from exc

        from se3diff_torch.benchmarks.core import MULTICONF_BENCHMARKS

        with h5py.File(outfile, mode="w", libver="latest") as h5:
            for label, covs in self.coverage.items():
                for mt, (thresholds, values) in covs.items():
                    grp = h5.create_group(f"coverage_{label}_{mt.value}")
                    grp.create_dataset("thresholds", data=thresholds)
                    grp.create_dataset("values", data=values)

            for label, recs in self.krecall.items():
                for mt, by_case in recs.items():
                    grp = h5.create_group(f"krecall_{label}_{mt.value}")
                    for test_case, (km, kstd) in by_case.items():
                        grp.create_dataset(test_case, data=np.array([km, kstd]))

            sgr = h5.create_group("sample_metrics")
            is_multiconf = self.benchmark in MULTICONF_BENCHMARKS
            rgr = h5.create_group("reference_metrics") if is_multiconf else None

            for test_case, res in self.per_system.items():
                case_grp = sgr.create_group(test_case)
                if is_multiconf and res.topology_ids is not None:
                    case_grp.create_dataset("topology_ids", data=res.topology_ids)
                for mt, arr in res.metrics_against_references.items():
                    case_grp.create_dataset(mt.value, data=arr)
                if rgr is not None and res.references_names is not None:
                    ref_grp = rgr.create_group(test_case)
                    ref_grp.create_dataset(
                        "references_names", data=res.references_names
                    )
                    if res.metrics_between_references is not None:
                        for mt, between in res.metrics_between_references.items():
                            if between is None:
                                continue
                            for (i, j), value in between.items():
                                ref_grp.create_dataset(
                                    f"{mt.value}_{i}_{j}", data=value
                                )

    def save_results(self, output_dir) -> None:
        os.makedirs(output_dir, exist_ok=True)
        arrays: dict[str, np.ndarray] = {}
        summary: dict = {"benchmark": self.benchmark.value, "krecall": {}, "coverage_at_threshold": {}}
        for label, covs in self.coverage.items():
            for mt, (thr, vals) in covs.items():
                arrays[f"coverage_{label}_{mt.value}_thresholds"] = thr
                arrays[f"coverage_{label}_{mt.value}_values"] = vals
                t = BENCHMARK_SPECIFIC_SUCCESS_THRESHOLDS.get(self.benchmark, {}).get(
                    mt, METRICS_SUCCESS_THRESHOLD.get(mt)
                )
                if t is not None:
                    j = int(np.argmin(np.abs(thr - t)))
                    summary["coverage_at_threshold"].setdefault(label, {})[mt.value] = {
                        "threshold": float(thr[j]),
                        "mean": float(vals[:, j].mean()),
                        "std": float(vals[:, j].std()),
                    }
        for label, recs in self.krecall.items():
            summary["krecall"][label] = {
                mt.value: {s: {"mean": v[0], "std": v[1]} for s, v in d.items()}
                for mt, d in recs.items()
            }
        # Per-system raw metric arrays.
        for tc, res in self.per_system.items():
            for mt, arr in res.metrics_against_references.items():
                arrays[f"per_system_{tc}_{mt.value}"] = arr
        np.savez(os.path.join(output_dir, "multiconf_results.npz"), **arrays)
        with open(os.path.join(output_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        # Reference-format H5 last: the npz/json outputs above must not be
        # lost when the optional h5py dependency is absent.
        try:
            self.save_to_h5(os.path.join(output_dir, "results.h5"))
        except ImportError as exc:
            logging.getLogger(__name__).warning(
                "skipping results.h5: %s", exc
            )

    def to_metrics_json(self) -> dict:
        out = {}
        for label, recs in self.krecall.items():
            for mt, d in recs.items():
                vals = [v[0] for v in d.values()]
                out[f"{label}/{mt.value}/k_recall_mean"] = float(np.mean(vals))
        return out

    def get_aggregate_metrics(self) -> dict[str, float]:
        """Uniform results contract (results.py:64): headline k-recall means
        plus mean coverage at each metric's success threshold."""
        out = self.to_metrics_json()
        for label, covs in self.coverage.items():
            for mt, (thr, vals) in covs.items():
                t = BENCHMARK_SPECIFIC_SUCCESS_THRESHOLDS.get(
                    self.benchmark, {}
                ).get(mt, METRICS_SUCCESS_THRESHOLD.get(mt))
                if t is None:
                    continue
                j = int(np.argmin(np.abs(thr - t)))
                out[f"{label}/{mt.value}/coverage"] = float(vals[:, j].mean())
        return out

    def plot(self, output_dir) -> None:
        """Coverage curves, k-recall bars, 2D per-system free-energy
        landscape grids (2-reference benchmarks), and smoothed FNC curves
        (unfolding benchmarks) — counterpart of eval/multiconf/plot.py +
        results.py:94-215."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from se3diff_torch.benchmarks import plots

        os.makedirs(output_dir, exist_ok=True)
        for label, covs in self.coverage.items():
            fig, axes = plt.subplots(
                1, len(covs), figsize=(4 * len(covs), 3.2), squeeze=False
            )
            for ax, (mt, (thr, vals)) in zip(axes[0], covs.items()):
                t = BENCHMARK_SPECIFIC_SUCCESS_THRESHOLDS.get(
                    self.benchmark, {}
                ).get(mt, METRICS_SUCCESS_THRESHOLD.get(mt))
                plots.plot_coverage_bootstrap(
                    thr, vals, mt, ax=ax,
                    success_threshold=t if t is not None else float(thr[-1]),
                )
                ax.set_xlabel(mt.value)
                ax.set_ylabel("coverage")
            fig.tight_layout()
            fig.savefig(os.path.join(output_dir, f"coverage_{label}.png"), dpi=120)
            plt.close(fig)

        # 2D ref0-vs-ref1 free-energy landscape grid per metric, for
        # benchmarks with exactly two references (plot.py:193-240).
        mts = {
            mt
            for res in self.per_system.values()
            for mt, arr in res.metrics_against_references.items()
            if arr.shape[1] == 2
        }
        for mt in mts:
            grid = {
                tc: res.metrics_against_references[mt]
                for tc, res in self.per_system.items()
                if res.metrics_against_references.get(mt) is not None
                and res.metrics_against_references[mt].shape[1] == 2
            }
            if grid and mt in METRICS_SUCCESS_THRESHOLD:
                fig = plots.plot_2d_free_energy_landscapes_in_grid(grid, mt)
                fig.savefig(
                    os.path.join(
                        output_dir, f"landscape2d_{mt.value.replace('/', '_')}.png"
                    ),
                    dpi=120,
                )
                plt.close(fig)

        # Smoothed FNC free-energy grid for the unfolding benchmarks
        # (plot.py:311-334); FNC metrics are single-reference in [0, 1].
        fnc_mts = [
            mt
            for mt in (MetricType.FNC_UNFOLD_U, MetricType.FNC_UNFOLD_F)
            if any(
                mt in res.metrics_against_references
                for res in self.per_system.values()
            )
        ]
        for mt in fnc_mts:
            grid = {
                tc: res.metrics_against_references[mt][:, 0]
                for tc, res in self.per_system.items()
                if mt in res.metrics_against_references
            }
            fig = plots.plot_free_energy_landscapes_by_fnc_in_grid(grid)
            fig.savefig(
                os.path.join(
                    output_dir, f"fnc_landscape_{mt.value.replace('/', '_')}.png"
                ),
                dpi=120,
            )
            plt.close(fig)

        # k-recall bars with bootstrap std per test case.
        for label, recs in self.krecall.items():
            for mt, d in recs.items():
                if not d:
                    continue
                names = sorted(d)
                means = [d[n][0] for n in names]
                stds = [d[n][1] for n in names]
                fig, ax = plt.subplots(
                    figsize=(max(4, 0.35 * len(names)), 3.2)
                )
                ax.bar(range(len(names)), means, yerr=stds, capsize=2)
                t = METRICS_SUCCESS_THRESHOLD.get(mt)
                if t is not None:
                    ax.axhline(t, ls="--", c="grey")
                ax.set_xticks(range(len(names)))
                ax.set_xticklabels(names, rotation=90, fontsize=6)
                ax.set_ylabel(f"1-recall ({mt.value})")
                fig.tight_layout()
                fig.savefig(
                    os.path.join(
                        output_dir, f"krecall_{label}_{mt.value.replace('/', '_')}.png"
                    ),
                    dpi=120,
                )
                plt.close(fig)

        # Per-system free-energy landscapes over the best metric: -log of the
        # per-sample metric histogram against each reference
        # (results.py:94-215's landscape grid, simplified to histograms).
        mt0 = next(iter(next(iter(self.coverage.values()))))
        per = {
            tc: res.metrics_against_references.get(mt0)
            for tc, res in self.per_system.items()
        }
        per = {tc: v for tc, v in per.items() if v is not None}
        if per:
            n = len(per)
            ncol = min(n, 5)
            nrow = -(-n // ncol)
            fig, axes = plt.subplots(
                nrow, ncol, figsize=(3 * ncol, 2.4 * nrow), squeeze=False
            )
            for ax, (tc, arr) in zip(axes.flat, sorted(per.items())):
                for r in range(arr.shape[1]):
                    hist, edges = np.histogram(arr[:, r], bins=40, density=True)
                    centers = 0.5 * (edges[1:] + edges[:-1])
                    with np.errstate(divide="ignore"):
                        fe = -np.log(hist)
                    ax.plot(centers, fe, lw=0.8, label=f"ref {r}")
                ax.set_title(tc, fontsize=7)
                ax.set_xlabel(mt0.value, fontsize=7)
                ax.set_ylabel("-ln p", fontsize=7)
            for ax in list(axes.flat)[n:]:
                ax.axis("off")
            fig.tight_layout()
            fig.savefig(
                os.path.join(output_dir, f"landscape_{mt0.value}.png"), dpi=120
            )
            plt.close(fig)


def compute_coverage_and_k_recall(
    evals_per_test_case: dict[str, TestCaseResult],
    benchmark: Benchmark,
    seed: int = 0,
) -> MulticonfResults:
    """(summary_metrics.py:179-224 + crypticpocket variant :227-290)"""
    metric_types = list(
        next(iter(evals_per_test_case.values())).metrics_against_references.keys()
    )

    if benchmark == Benchmark.MULTICONF_CRYPTICPOCKET:
        split = {
            tc: split_holo_apo(res) for tc, res in evals_per_test_case.items()
        }
        groups = {
            f"{benchmark.value}_holo": {tc: s[0] for tc, s in split.items()},
            f"{benchmark.value}_apo": {tc: s[1] for tc, s in split.items()},
        }
    else:
        groups = {benchmark.value: evals_per_test_case}

    rng = np.random.default_rng(seed)
    cov = {}
    krec = {}
    for label, evals in groups.items():
        cov[label] = {
            mt: coverage_bootstrap(
                {tc: e.metrics_against_references[mt] for tc, e in evals.items()},
                metric_type=mt, rng=rng,
            )
            for mt in metric_types
        }
        krec[label] = {
            mt: k_recall_bootstrap(
                {tc: e.metrics_against_references[mt] for tc, e in evals.items()},
                metric_type=mt, rng=rng,
            )
            for mt in metric_types
        }
    return MulticonfResults(
        per_system=evals_per_test_case, coverage=cov, krecall=krec,
        benchmark=benchmark,
    )
