"""The worked training example's data, model and schedule.

``examples/torch_train_from_scratch.py`` (the counterpart of
``examples/train_from_scratch.py``) trains the JAX example's small DiG score
net on a synthetic "protein" dataset (noisy copies of one backbone
conformation), or on ensembles read from trajectories. What it builds lives
here, in the package, so that the ranks of its ``--mesh`` run
(:func:`se3diff_torch.parallel.programs.example_rank`, spawned processes
that import it) build the same batches, weights, SDEs and schedule as the
one-device run.
"""

from __future__ import annotations

import numpy as np
import torch

from se3diff_torch.diffusion import denoise
from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.ops.ipa_attention import check_card_widths
from se3diff_torch.sde.so3_sde import DiGSO3SDE
from se3diff_torch.sde.vpsde import CosineVPSDE
from se3diff_torch.training.loop import TrainConfig

L = 8
# The JAX example's model (examples/train_from_scratch.py).
JAX_MODEL = dict(num_layers=2, dim_model=32, dim_pair=16, num_heads=4, dim_hidden=64, dropout=0.0)
# The JAX example's --mesh: make_mesh(8, model_parallel=4), one head of 8 a
# model rank.
MESH = dict(data=2, model=4)
SO3 = dict(num_sigma=32, num_omega=256, l_max=500)
MIN_T = 0.05  # small tables: the IGSO(3) series is valid for l_max * sigma >> 3
SAMPLE_STEPS = 100


def make_dataset(rng: np.random.Generator):
    """One reference conformation; batches are small SE(3) perturbations of
    it (the JAX example's draws)."""
    theta = np.linspace(0, 2.5 * np.pi, L)
    ref_pos = np.stack(
        [np.cos(theta), np.sin(theta), np.linspace(0, 1.2, L)], axis=-1
    ).astype(np.float32) * 0.4
    ref_rotvec = rng.standard_normal((L, 3)).astype(np.float32) * 0.4

    # Fixed conditioning, like a real system's cached embeddings.
    single = rng.standard_normal((L, 384)).astype(np.float32) * 0.1
    pair = rng.standard_normal((L, L, 128)).astype(np.float32) * 0.1

    def batch_fn(step: int) -> dict:
        r = np.random.default_rng(step)
        B = 8
        pos = ref_pos[None] + r.standard_normal((B, L, 3)).astype(np.float32) * 0.05
        rotvec = ref_rotvec[None] + r.standard_normal((B, L, 3)).astype(np.float32) * 0.05
        return {
            "pos": pos,
            "rot": so3_ops.rotvec_to_rotmat(torch.from_numpy(rotvec)).numpy(),
            "single": np.broadcast_to(single, (B, L, 384)),
            "pair": np.broadcast_to(pair, (B, L, L, 128)),
        }

    return ref_pos, batch_fn


def batch_source(trajectory: list[str] | None, topology: list[str] | None, batch_size: int,
                 device) -> tuple:
    """``(batch_fn, description)``: the synthetic dataset's batches (drawn
    from seed 0), or with ``trajectory`` the ensembles'
    (``training/data.py``: one ``.xtc`` with its ``topology`` or a
    multi-model ``.pdb``; several are length-bucketed and masked), served on
    ``device``; ``description`` is None for the synthetic dataset."""
    if trajectory and len(trajectory) > 1:
        from se3diff_torch.training.data import MultiEnsembleDataset

        tops = topology or [None] * len(trajectory)
        mds = MultiEnsembleDataset.from_trajectories(list(zip(trajectory, tops)),
                                                     embeds_backend="dummy")
        return mds.batch_fn(batch_size, device=device), (
            f"{len(mds.datasets)} ensembles, {mds.num_frames} frames, "
            f"buckets {mds.occupied_buckets()}")
    if trajectory:
        from se3diff_torch.training.data import EnsembleDataset

        ds = EnsembleDataset.from_trajectory(trajectory[0], topology[0] if topology else None,
                                             embeds_backend="dummy")
        return ds.batch_fn(min(batch_size, ds.num_frames), device=device), (
            f"ensemble: {ds.num_frames} frames x {ds.num_residues} residues "
            f"({ds.sequence[:20]}{'...' if ds.num_residues > 20 else ''})")
    return make_dataset(np.random.default_rng(0))[1], None


def model_config(device, model: int = 1) -> dict:
    """The JAX example's widths, held against what ``device`` takes at f32
    with the heads split over ``model`` tensor-parallel ranks (the card's
    check raises ``ValueError`` on widths its kernels refuse; it reads no
    device state)."""
    check_card_widths({**JAX_MODEL, "num_heads": JAX_MODEL["num_heads"] // model,
                       "dim_model": JAX_MODEL["dim_model"] // model}, device, torch.float32)
    return JAX_MODEL


def build_model(cfg: dict, device) -> DiGConditionalScoreModel:
    """The score net, initialised from seed 0 with the JAX package's
    initialisers, on ``device``."""
    model = DiGConditionalScoreModel(**cfg)
    return init_weights(model, torch.Generator().manual_seed(0)).to(device)


def make_sdes(device) -> denoise.SDEs:
    return denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**SO3, device=device))


def train_config(steps: int, ckpt_dir: str) -> TrainConfig:
    """The JAX example's schedule: lr 2e-3, 20 warm-up steps (a quarter of
    short runs), 4 checkpoints and 10 logged losses a run."""
    return TrainConfig(
        num_steps=steps, lr=2e-3, warmup_steps=min(20, steps // 4), min_t=MIN_T,
        ckpt_every=max(steps // 4, 1), ckpt_dir=ckpt_dir, log_every=max(steps // 10, 1),
    )


def mean_pairwise_dist(pos: np.ndarray) -> float:
    d = np.linalg.norm(pos[..., None, :, :] - pos[..., :, None, :], axis=-1)
    iu = np.triu_indices(pos.shape[-2], k=1)
    return float(d[..., iu[0], iu[1]].mean())
