"""Sample discovery, test-case indexing, and physicality filtering.

Counterpart of ``se3diff_tpu/benchmarks/samples.py`` (the reference's
`bioemu-benchmarks/bioemu_benchmarks/samples.py`), backed by the port's PDB
parser and XTC codec instead of mdtraj. Samples join test cases by
sequence, so the sample CLI's ``topology.pdb`` + ``samples.xtc`` are found
as they are.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from se3diff_torch.benchmarks.core import Benchmark, rows_where
from se3diff_torch.benchmarks.trajectory import BackboneTraj, load_sample_traj
from se3diff_torch.struct.pdb import read_pdb
from se3diff_torch.struct.physics import get_physical_frame_indices
from se3diff_torch.struct.residues import ATOM37_C, ATOM37_CA, ATOM37_N, ATOM37_O

logger = logging.getLogger(__name__)


class MissingBackbone(Exception):
    pass


class NoSamples(Exception):
    pass


class MissingTopology(Exception):
    pass


@dataclass(frozen=True, eq=True)
class SequenceSample:
    """Paths to the files holding one sequence's samples (samples.py:17-39)."""

    topology_file: str
    trajectory_file: str
    frames_to_include: tuple[int, ...] | None = None

    def get_traj(self) -> BackboneTraj:
        idx = (
            np.asarray(self.frames_to_include)
            if self.frames_to_include is not None
            else None
        )
        return load_sample_traj(self.trajectory_file, self.topology_file, idx)

    def sequence(self) -> str:
        return read_pdb(self.topology_file).sequence


def find_samples_in_dir(samples_dir) -> list[SequenceSample]:
    """xtc + same-name pdb, else topology.pdb in the same directory
    (samples.py:64-89)."""
    out = []
    for f in sorted(Path(samples_dir).glob("**/*.xtc")):
        if f.with_suffix(".pdb").exists():
            out.append(SequenceSample(str(f.with_suffix(".pdb")), str(f)))
        elif (f.parent / "topology.pdb").exists():
            out.append(SequenceSample(str(f.parent / "topology.pdb"), str(f)))
        else:
            raise MissingTopology(f"No .pdb topology found for {f}")
    return out


def assert_topology_has_backbone_atoms(topology_file: str) -> None:
    struct = read_pdb(topology_file)
    bb = struct.mask[:, [ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_O]]
    if not bb.all():
        raise MissingBackbone(f"{topology_file} is missing backbone atoms")


class IndexedSamples:
    """test_case -> [SequenceSample] (samples.py:105-173)."""

    def __init__(self, test_case_to_sequencesamples: dict[str, list[SequenceSample]]):
        assert test_case_to_sequencesamples, "Empty input"
        self.test_case_to_sequencesamples = test_case_to_sequencesamples

    @classmethod
    def from_benchmark(
        cls, benchmark: Benchmark, sequence_samples: list[SequenceSample]
    ) -> "IndexedSamples":
        md = benchmark.metadata
        benchmark_sequences = {row["sequence"] for row in md}

        test_case_to_ss: dict[str, list[SequenceSample]] = defaultdict(list)
        sampled: set[str] = set()
        n_irrelevant = 0
        for ss in sequence_samples:
            seq = ss.sequence()
            if seq not in benchmark_sequences:
                n_irrelevant += 1
                continue
            assert_topology_has_backbone_atoms(ss.topology_file)
            sampled.add(seq)
            for row in rows_where(md, "sequence", seq):
                test_case_to_ss[str(row["test_case"])].append(ss)

        if n_irrelevant:
            logger.info("Ignoring samples for %d irrelevant sequences.", n_irrelevant)
        if not sampled:
            raise NoSamples("No samples found for benchmark.")
        missing = benchmark_sequences - sampled
        if missing:
            logger.warning(
                "Missing samples for %d sequence(s) for this benchmark.", len(missing)
            )
        return cls(dict(test_case_to_ss))

    def get_trajs_for_test_case(self, test_case: str) -> list[BackboneTraj]:
        return [ss.get_traj() for ss in self.test_case_to_sequencesamples[test_case]]

    def __repr__(self):
        return f"IndexedSamples(test_cases={list(self.test_case_to_sequencesamples)})"


def _physical_indices_for(ss: SequenceSample) -> np.ndarray:
    """Physicality filter on the full atom37 frames (utils.py:125-296 in the
    benchmark repo; same thresholds as struct.physics)."""
    struct = read_pdb(ss.topology_file)
    if ss.trajectory_file.endswith(".xtc"):
        from se3diff_torch.struct import xtc

        coords = np.asarray(xtc.read_xtc(ss.trajectory_file)[0], np.float64) * 10.0
        F = coords.shape[0]
        atom37 = np.zeros((F, struct.mask.shape[0], 37, 3), np.float32)
        flat = struct.atom_order  # topology-file atom order, not slot order
        atom37[:, flat[:, 0], flat[:, 1]] = coords
    else:
        atom37 = read_pdb(ss.trajectory_file).atom37
    return get_physical_frame_indices(atom37, struct.mask, device=False)


def filter_unphysical_samples(
    indexed_samples: IndexedSamples,
) -> tuple[IndexedSamples, dict[str, np.ndarray]]:
    """Drop unphysical frames; report kept fraction per test case
    (samples.py:176-254)."""
    filtered: dict[str, list[SequenceSample]] = {}
    kept_frac: dict[str, np.ndarray] = {}
    for test_case, sss in indexed_samples.test_case_to_sequencesamples.items():
        new_list, fracs = [], []
        for ss in sss:
            assert ss.frames_to_include is None
            idx = _physical_indices_for(ss)
            n_total = ss.get_traj().n_frames
            fracs.append(len(idx) / max(n_total, 1))
            if len(idx) == 0:
                logger.warning(
                    "Filtered all samples for test case %s (%s)",
                    test_case, ss.trajectory_file,
                )
                continue
            new_list.append(
                SequenceSample(
                    ss.topology_file, ss.trajectory_file, tuple(int(i) for i in idx)
                )
            )
        if new_list:
            filtered[test_case] = new_list
        kept_frac[test_case] = np.asarray(fracs)
    return IndexedSamples(filtered), kept_frac
