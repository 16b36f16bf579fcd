"""Worked example: train an SE(3) score network from scratch, on the PyTorch
port (``se3diff_torch``).

Counterpart of ``examples/train_from_scratch.py``: a small DiG score net
learns, by denoising score matching (``training/dsm.py``), the SE(3)
marginals of a synthetic "protein" dataset (noisy copies of one backbone
conformation), with the trainer loop's warmup+cosine schedule, checkpoints
and exact resume (``training/loop.py``). The batches are the JAX example's
draw for draw; the data, the model and the schedule are
``se3diff_torch/training/example.py``.

Run:  python examples/torch_train_from_scratch.py [--steps 500] [--device cuda|cpu] [--mesh]

The model is the JAX example's (2 layers, ``dim_model=32``, 4 heads of 8,
``dim_pair=16``) on either device; on the card its attention runs K1's
4-head designs ("h4s" forward, "bwd_h4s" backward).

``--mesh`` trains DP+TP-sharded on the JAX example's mesh, data=2 x model=4
(``make_mesh(8, model_parallel=4)``): 8 ranks, each with half of every batch
and one head of 8 of every attention ("h1s" forward, "bwd_h1s" backward on
the card). With ``--device cuda`` a rank takes a GPU of its own (NCCL), so 8
must be visible (the run is refused before any rank starts otherwise); with
``--device cpu`` the ranks are 8 gloo processes. Rank 0 writes the
checkpoints in the one-device layout; the sampling below runs here, on the
full weights rank 0 gathers after the last step. Its losses are the
one-device run's to float rounding.

After training, reverse-diffusion samples from the learned score are
compared against the data: their mean pairwise Ca distance
(translation-invariant; the diffused center of mass is unpinned) contracts
from the prior's ~2.2 toward the dataset's 0.64. After 500 steps it is
about 1.8-1.9 in either package, averaged over 16 sampling draws of each
of five or six training seeds; one draw of 8 samples scatters from 0.8 to
4 (``scripts/train_example_spread.py``; the JAX example's "~1.0" is its
seed-0 model's first draw).
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
from se3diff_torch.models.dig import DiGConditionalScoreModel  # noqa: E402
from se3diff_torch.training.example import (  # noqa: E402, F401 (the example's names)
    JAX_MODEL, L, MESH, MIN_T, SAMPLE_STEPS, SO3, batch_source, build_model, make_dataset,
    make_sdes, mean_pairwise_dist, model_config, train_config,
)
from se3diff_torch.training.loop import train_dsm  # noqa: E402


def train_mesh(args, ckpt_dir: str) -> tuple[DiGConditionalScoreModel, list[float], list[dict]]:
    """The example's training on the ``MESH`` ranks (programs.example_rank);
    returns the full model rank 0 gathered, on ``args.device``, the global
    losses and every rank's result."""
    from se3diff_torch.parallel import launch, programs
    from se3diff_torch.train import _check_mesh

    data, model = MESH["data"], MESH["model"]
    if args.batch_size < data:
        raise SystemExit(f"--batch_size {args.batch_size} cannot split over data={data}")
    devices = _check_mesh(JAX_MODEL, data, model, args.device)
    print(f"training on mesh {dict(MESH)}")
    results = launch.run_ranks(
        programs.example_rank, data * model, devices,
        args=(args.steps, ckpt_dir, data, model, args.trajectory, args.topology, args.batch_size))
    net = DiGConditionalScoreModel(**JAX_MODEL)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in results[0]["weights"].items()},
                        strict=True)
    return net.to(args.device), results[0]["history"], results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--mesh", action="store_true",
                    help="train DP+TP-sharded on an 8-rank mesh (data=2, model=4): one GPU a "
                         "rank with --device cuda, gloo processes with --device cpu")
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
    if not args.mesh and args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but CUDA is not available (use --device cpu)")

    cfg_model = model_config(args.device, MESH["model"] if args.mesh else 1)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="se3diff_torch_train_")
    t0 = time.perf_counter()
    ranks = None
    if args.mesh:
        model, history, ranks = train_mesh(args, ckpt_dir)
    batch_fn, desc = batch_source(args.trajectory, args.topology, args.batch_size, args.device)
    if desc:
        print(desc)
    sdes = make_sdes(args.device)
    if not args.mesh:
        model = build_model(cfg_model, args.device)
        model, history = train_dsm(sdes, model, batch_fn, train_config(args.steps, ckpt_dir),
                                   val_batch=batch_fn(10_000))
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
                model=cfg_model, train_s=train_s, sample_s=sample_s,
                weights={k: v.detach().cpu() for k, v in model.state_dict().items()},
                ranks=ranks)


if __name__ == "__main__":
    main()
