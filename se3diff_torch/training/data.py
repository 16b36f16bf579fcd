"""Training data: structure ensembles -> DSM batches.

Counterpart of ``se3diff_tpu/training/data.py``. An ensemble (topology PDB
+ XTC trajectory through the native codec, or a multi-model PDB) becomes
rigid frames (`struct/atoms.py::frames_from_backbone`) with conditioning
embeddings from the `sampling/embeds.py` cache, once, on the host, in
numpy. Batches are deterministic functions of the step index, with the JAX
package's numpy seeding (``(seed, epoch)`` for one ensemble, ``(seed, step)``
for many), so the same seed draws the same frames in both packages and a
resumed run re-derives exactly the batches it missed.

``batch`` gives the numpy form (conditioning broadcast over the batch);
``batch_fn`` moves the step-invariant conditioning to the device once, as
tensors without the batch axis, which `training/dsm.py` expands. The
per-step host-to-device copy is then the frame batch alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["EnsembleDataset", "MultiEnsembleDataset"]


@dataclasses.dataclass(frozen=True)
class EnsembleDataset:
    """A conformational ensemble of ONE sequence as DSM training data.

    ``pos [F, R, 3]`` frame translations in nm (centred per frame),
    ``rot [F, R, 3, 3]`` frame rotations, ``single [R, S]`` /
    ``pair [R, R, P]`` conditioning embeddings, one-letter ``sequence``.
    """

    pos: np.ndarray
    rot: np.ndarray
    single: np.ndarray
    pair: np.ndarray
    sequence: str

    @property
    def num_frames(self) -> int:
        return self.pos.shape[0]

    @property
    def num_residues(self) -> int:
        return self.pos.shape[1]

    @classmethod
    def from_trajectory(
        cls,
        trajectory_file,
        topology_file=None,
        *,
        single: np.ndarray | None = None,
        pair: np.ndarray | None = None,
        embeds_backend: str = "dummy",
        cache_embeds_dir=None,
    ) -> "EnsembleDataset":
        """Load ``topology.pdb + .xtc`` (or a multi-model PDB when
        ``topology_file`` is None) and build frames, centred per frame, and
        conditioning.

        Conditioning comes from explicit ``single``/``pair`` arrays when
        given, otherwise from the embeddings cache for the topology's
        sequence (``embeds_backend="dummy"`` needs no network or colabfold).
        """
        from se3diff_torch.benchmarks.trajectory import load_reference_pdb, load_sample_traj
        from se3diff_torch.struct.atoms import frames_from_backbone

        if topology_file is None:
            suffix = str(trajectory_file).rsplit(".", 1)[-1].lower()
            if suffix not in ("pdb", "cif"):
                raise ValueError(
                    f"a .{suffix} trajectory needs a topology PDB (topology_file=...); "
                    "only multi-model .pdb/.cif files stand alone"
                )
            traj = load_reference_pdb(trajectory_file)
        else:
            traj = load_sample_traj(trajectory_file, topology_file)

        # BackboneTraj layout: [F, R, 4, 3] Angstroms, (N, CA, C, O).
        pos, rot = frames_from_backbone(
            traj.coords[:, :, 0], traj.coords[:, :, 1], traj.coords[:, :, 2]
        )
        pos = pos - pos.mean(axis=1, keepdims=True)

        if single is None or pair is None:
            from se3diff_torch.sampling.embeds import get_embeds

            single_path, pair_path = get_embeds(
                traj.sequence, cache_embeds_dir=cache_embeds_dir, backend=embeds_backend
            )
            if single is None:
                single = np.load(single_path)
            if pair is None:
                pair = np.load(pair_path)
        single = np.asarray(single, np.float32)
        pair = np.asarray(pair, np.float32)
        R = pos.shape[1]
        if single.shape[0] != R or pair.shape[:2] != (R, R):
            raise ValueError(
                f"conditioning shapes {single.shape}/{pair.shape} do not match "
                f"the trajectory's {R} residues"
            )
        return cls(pos=pos, rot=rot, single=single, pair=pair, sequence=traj.sequence)

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        """DSM batch for the given frame indices (no mask: one dense sequence).
        The conditioning is a broadcast view, not a copy."""
        B = len(idx)
        return {
            "pos": self.pos[idx],
            "rot": self.rot[idx],
            "single": np.broadcast_to(self.single, (B, *self.single.shape)),
            "pair": np.broadcast_to(self.pair, (B, *self.pair.shape)),
        }

    def batch_fn(
        self, batch_size: int, seed: int = 0, device: str | torch.device = "cuda"
    ) -> Callable[[int], dict]:
        """Deterministic ``step -> batch``: each epoch is an independent
        seeded permutation of the frames, so a resumed run at step k
        re-derives exactly batch k.

        Frames are numpy; the conditioning goes to ``device`` at the first
        call and is served unbatched (``single [L, S]``, ``pair [L, L, P]``
        tensors).
        """
        F = self.num_frames
        if batch_size > F:
            raise ValueError(f"batch_size {batch_size} > {F} frames")
        per_epoch = F // batch_size
        cond: list[torch.Tensor] = []

        def fn(step: int) -> dict:
            epoch, k = divmod(step, per_epoch)
            perm = np.random.default_rng((seed, epoch)).permutation(F)
            idx = perm[k * batch_size:(k + 1) * batch_size]
            if not cond:
                cond.extend(torch.from_numpy(x).to(device) for x in (self.single, self.pair))
            return {"pos": self.pos[idx], "rot": self.rot[idx], "single": cond[0], "pair": cond[1]}

        return fn


@dataclasses.dataclass(frozen=True)
class MultiEnsembleDataset:
    """Many single-sequence ensembles as one DSM training stream.

    Each batch holds one system (conditioning is per sequence), padded up to
    the system's *length bucket*, so the train step sees as many shapes as
    there are occupied buckets. Padding carries ``mask=False`` rows, zero
    positions and conditioning, and identity rotations; the model masks them
    out of attention and `dsm_loss` out of the loss.
    """

    datasets: tuple[EnsembleDataset, ...]
    bucket: int = 32
    # Per-system padded (single, pair), built once on first use.
    _padded: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_trajectories(cls, pairs, *, bucket: int = 32, **kwargs) -> "MultiEnsembleDataset":
        """``pairs``: iterable of (trajectory_file, topology_file_or_None);
        ``kwargs`` go to :meth:`EnsembleDataset.from_trajectory`."""
        datasets = tuple(EnsembleDataset.from_trajectory(traj, top, **kwargs) for traj, top in pairs)
        if not datasets:
            raise ValueError("no ensembles given")
        return cls(datasets=datasets, bucket=bucket)

    @property
    def num_frames(self) -> int:
        return sum(d.num_frames for d in self.datasets)

    def padded_length(self, i: int) -> int:
        R = self.datasets[i].num_residues
        return -(-R // self.bucket) * self.bucket

    def occupied_buckets(self) -> list[int]:
        return sorted({self.padded_length(i) for i in range(len(self.datasets))})

    def _padded_cond(self, system: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(single [L, S], pair [L, L, P], mask [L])`` padded to the bucket."""
        if system not in self._padded:
            ds = self.datasets[system]
            R, L = ds.num_residues, self.padded_length(system)
            single = np.zeros((L, ds.single.shape[-1]), np.float32)
            pair = np.zeros((L, L, ds.pair.shape[-1]), np.float32)
            single[:R] = ds.single
            pair[:R, :R] = ds.pair
            mask = np.zeros((L,), bool)
            mask[:R] = True
            self._padded[system] = (single, pair, mask)
        return self._padded[system]

    def _padded_frames(self, system: int, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        ds = self.datasets[system]
        pos, rot = ds.pos[idx], ds.rot[idx]
        B, pad = len(idx), self.padded_length(system) - ds.num_residues
        if pad:
            pos = np.concatenate([pos, np.zeros((B, pad, 3), np.float32)], axis=1)
            eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, pad, 3, 3))
            rot = np.concatenate([rot, eye], axis=1)
        return pos, rot

    def batch(self, system: int, idx: np.ndarray) -> dict[str, np.ndarray]:
        """Padded, masked batch of frames ``idx`` from ``system``."""
        idx = np.asarray(idx)
        B = len(idx)
        pos, rot = self._padded_frames(system, idx)
        single, pair, mask = self._padded_cond(system)
        return {
            "pos": pos,
            "rot": rot,
            "single": np.broadcast_to(single, (B, *single.shape)),
            "pair": np.broadcast_to(pair, (B, *pair.shape)),
            "mask": np.broadcast_to(mask, (B, len(mask))),
        }

    def batch_fn(
        self, batch_size: int, seed: int = 0, device: str | torch.device = "cuda"
    ) -> Callable[[int], dict]:
        """Deterministic ``step -> batch``: each step draws one system
        (weighted by frame count) and ``batch_size`` of its frames, with
        replacement when it has fewer, from ``default_rng((seed, step))``.

        Frames are numpy; each system's padded conditioning and mask go to
        ``device`` at first use and are served unbatched (``single [L, S]``,
        ``pair [L, L, P]``, ``mask [L]`` tensors)."""
        weights = np.array([d.num_frames for d in self.datasets], np.float64)
        weights /= weights.sum()
        staged: dict[int, tuple[torch.Tensor, ...]] = {}

        def fn(step: int) -> dict:
            r = np.random.default_rng((seed, step))
            system = int(r.choice(len(self.datasets), p=weights))
            F = self.datasets[system].num_frames
            idx = r.choice(F, size=batch_size, replace=batch_size > F)
            if system not in staged:
                staged[system] = tuple(
                    torch.from_numpy(x).to(device) for x in self._padded_cond(system)
                )
            pos, rot = self._padded_frames(system, idx)
            single, pair, mask = staged[system]
            return {"pos": pos, "rot": rot, "single": single, "pair": pair, "mask": mask}

        return fn
