"""Worked example: train an SE(3) score network from scratch, on the PyTorch
port (``se3diff_torch``).

Counterpart of ``examples/train_from_scratch.py``: a small DiG score net
learns, by denoising score matching (``training/dsm.py``), the SE(3)
marginals of a synthetic "protein" dataset (noisy copies of one backbone
conformation), with the trainer loop's warmup+cosine schedule, checkpoints
and exact resume (``training/loop.py``). The batches are the JAX example's
draw for draw.

Run:  python examples/torch_train_from_scratch.py [--steps 500] [--device cuda|cpu]

The model is the JAX example's (2 layers, ``dim_model=32``, 4 heads of 8,
``dim_pair=16``) on either device; on the card its attention runs K1's
4-head designs ("h4s" forward, "bwd_h4s" backward).

After training, reverse-diffusion samples from the learned score are
compared against the data: their mean pairwise Ca distance
(translation-invariant; the diffused center of mass is unpinned) contracts
from the prior's ~2.2 toward the dataset's 0.64. After 500 steps it is
about 1.8-1.9 in either package, averaged over 16 sampling draws of each
of five or six training seeds; one draw of 8 samples scatters from 0.8 to
4 (``scripts/train_example_spread.py``; the JAX example's "~1.0" is its
seed-0 model's first draw). ``--mesh`` of the JAX example has no
counterpart here: the port's DP+TP training is ``python -m
se3diff_torch.train --mesh``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from se3diff_torch.diffusion import denoise  # noqa: E402
from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights  # noqa: E402
from se3diff_torch.ops import so3 as so3_ops  # noqa: E402
from se3diff_torch.ops.ipa_attention import check_card_widths  # noqa: E402
from se3diff_torch.sde.so3_sde import DiGSO3SDE  # noqa: E402
from se3diff_torch.sde.vpsde import CosineVPSDE  # noqa: E402
from se3diff_torch.training.loop import TrainConfig, train_dsm  # noqa: E402

L = 8
# The JAX example's model (examples/train_from_scratch.py).
JAX_MODEL = dict(num_layers=2, dim_model=32, dim_pair=16, num_heads=4, dim_hidden=64, dropout=0.0)
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


def mean_pairwise_dist(pos: np.ndarray) -> float:
    d = np.linalg.norm(pos[..., None, :, :] - pos[..., :, None, :], axis=-1)
    iu = np.triu_indices(pos.shape[-2], k=1)
    return float(d[..., iu[0], iu[1]].mean())


def model_config(device: str) -> dict:
    """The JAX example's widths, held against what ``device`` takes (the
    card's check raises on widths its kernels refuse; it reads no device
    state)."""
    check_card_widths(JAX_MODEL, device)
    return JAX_MODEL


def build_model(cfg: dict, device: str) -> DiGConditionalScoreModel:
    """The score net, initialised from seed 0 with the JAX package's
    initialisers, on ``device``."""
    model = DiGConditionalScoreModel(**cfg)
    return init_weights(model, torch.Generator().manual_seed(0)).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--trajectory", action="append", default=None,
                    help="train on a real ensemble: .xtc (with --topology) "
                         "or multi-model .pdb (training/data.py) instead of "
                         "the synthetic dataset; repeat for multi-system "
                         "training (length-bucketed, masked batches)")
    ap.add_argument("--topology", action="append", default=None,
                    help="topology .pdb for an .xtc --trajectory (repeat "
                         "in the same order)")
    ap.add_argument("--batch_size", type=int, default=8)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but CUDA is not available (use --device cpu)")

    rng = np.random.default_rng(0)
    if args.trajectory and len(args.trajectory) > 1:
        from se3diff_torch.training.data import MultiEnsembleDataset

        tops = args.topology or [None] * len(args.trajectory)
        mds = MultiEnsembleDataset.from_trajectories(
            list(zip(args.trajectory, tops)), embeds_backend="dummy"
        )
        print(f"{len(mds.datasets)} ensembles, {mds.num_frames} frames, "
              f"buckets {mds.occupied_buckets()}")
        batch_fn = mds.batch_fn(args.batch_size, device=args.device)
    elif args.trajectory:
        from se3diff_torch.training.data import EnsembleDataset

        ds = EnsembleDataset.from_trajectory(
            args.trajectory[0], args.topology[0] if args.topology else None,
            embeds_backend="dummy",
        )
        print(f"ensemble: {ds.num_frames} frames x {ds.num_residues} residues "
              f"({ds.sequence[:20]}{'...' if ds.num_residues > 20 else ''})")
        batch_fn = ds.batch_fn(min(args.batch_size, ds.num_frames), device=args.device)
    else:
        _, batch_fn = make_dataset(rng)

    cfg_model = model_config(args.device)
    model = build_model(cfg_model, args.device)
    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**SO3, device=args.device))

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="se3diff_torch_train_")
    cfg = TrainConfig(
        num_steps=args.steps, lr=2e-3, warmup_steps=min(20, args.steps // 4),
        min_t=MIN_T, ckpt_every=max(args.steps // 4, 1), ckpt_dir=ckpt_dir,
        log_every=max(args.steps // 10, 1),
    )
    t0 = time.perf_counter()
    model, history = train_dsm(sdes, model, batch_fn, cfg, val_batch=batch_fn(10_000))
    train_s = time.perf_counter() - t0
    print(f"loss: {history[0]:.4f} -> {history[-1]:.4f} "
          f"({args.steps} steps in {train_s:.1f} s; checkpoints in {ckpt_dir})")

    # Sample the learned score and compare a translation-invariant geometry
    # statistic against the data. Euler–Maruyama, as in the JAX example: the
    # multistep solvers extrapolate the score and are brittle on a briefly
    # trained net.
    b = batch_fn(0)
    B, length = b["pos"].shape[:2]

    def batched(x, ndim):
        """A conditioning entry on the device, with the batch axis (the
        ensemble datasets serve it without one)."""
        x = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x,
                            device=args.device)
        return x.expand(B, *x.shape) if x.ndim == ndim else x

    single, pair = batched(b["single"], 2), batched(b["pair"], 3)
    mask = None if b.get("mask") is None else batched(b["mask"], 1)
    model.eval()

    def model_fn(pos, rot, t):
        return model(pos, rot, t, single, pair, mask)

    t0 = time.perf_counter()
    with torch.no_grad():
        pos, _ = denoise.euler_maruyama(
            torch.Generator(device=args.device).manual_seed(42), sdes, model_fn,
            batch=B, length=length, num_steps=SAMPLE_STEPS, min_t=MIN_T,
        )
    sample_s = time.perf_counter() - t0
    d_model = mean_pairwise_dist(pos.cpu().numpy())
    d_data = mean_pairwise_dist(np.asarray(b["pos"]))
    prior = torch.randn((B, length, 3), generator=torch.Generator().manual_seed(7))
    d_prior = mean_pairwise_dist(prior.numpy())
    print(f"mean pairwise distance: samples {d_model:.3f} vs data {d_data:.3f} "
          f"(prior {d_prior:.3f}); {SAMPLE_STEPS} EM steps in {sample_s:.1f} s")
    return dict(history=history, d_model=d_model, d_data=d_data, d_prior=d_prior,
                model=cfg_model, train_s=train_s, sample_s=sample_s)


if __name__ == "__main__":
    main()
