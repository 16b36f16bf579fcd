"""CLI: train an SE(3) score network on structure ensembles.

Counterpart of ``python -m se3diff_tpu.train``: DSM training over PDB/XTC
ensembles (`training/data.py`), warmup + cosine AdamW with checkpoints and
exact resume (`training/loop.py`), on one device or, with ``--mesh``, data-
and tensor-parallel over local ranks.

    python -m se3diff_torch.train \\
        --trajectory sys1.xtc --topology sys1.pdb \\
        --trajectory sys2.xtc --topology sys2.pdb \\
        --steps 10000 --batch_size 8 --ckpt_dir ckpts/ [--device cuda] \\
        [--mesh data=2,model=2]

Runs on the GPU unless ``--device cpu`` is given. There is no ``--kernel``
choice: on the GPU the IPA attention core always runs as the CUDA kernel,
with its row-chunked PyTorch backward; on the CPU it runs its plain version.

``--mesh data=N,model=M`` (parsed as the JAX CLI parses it; a missing axis
is 1) spawns N*M ranks, one process each (``parallel.launch.run_ranks``):
the batch splits into N shards and each model group of M contiguous ranks
splits the attention heads and the FFN's hidden units, so K1 runs on each
rank's H/M heads. With ``--device cuda`` rank r takes ``cuda:r`` (NCCL) and
fewer visible GPUs than ranks is an error; ``--device cpu`` runs gloo
ranks on the CPU. Head splits that do not divide the heads, or that leave
widths the card's kernels refuse, are refused before any rank starts. The
step equals one process's on the whole batch (``training/dsm.py::
mesh_train_step``); rank 0 writes the checkpoints, the metrics and the
export.

Re-running with the same ``--ckpt_dir`` resumes from the latest checkpoint
and reproduces the uninterrupted run (batches and noise are functions of the
step index); a checkpoint holds the full model and optimizer state, so a
run resumes under another mesh too. The final weights are exported as
``{ckpt_dir}/params.npz`` in the reference state-dict layout, with a
``config.yaml`` beside it; both this package's and the JAX package's
``load_bundle`` read the pair.
"""

from __future__ import annotations

import argparse
import logging
import sys

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m se3diff_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--trajectory", action="append", required=True,
                   help=".xtc (with --topology) or multi-model .pdb; repeat for "
                        "multi-system training (length-bucketed, masked batches)")
    p.add_argument("--topology", action="append", default=None,
                   help="topology .pdb per .xtc --trajectory (same order)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--bucket", type=int, default=32,
                   help="pad lengths to multiples of this (train-step shapes = "
                        "occupied buckets)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--min_t", type=float, default=0.001,
                   help="needs l_max*sigma(min_t) >> 3; the default matches the "
                        "production tables (l_max=2000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint directory; reuse it to resume exactly")
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--model_config_path", default=None,
                   help="reference-format config.yaml defining the score net "
                        "(default: the bioemu-v1.0 architecture)")
    p.add_argument("--init_ckpt_path", default=None,
                   help="warm-start from a torch/npz checkpoint instead of "
                        "random init (continued training)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="model compute dtype (parameters stay f32)")
    p.add_argument("--so3_cache_dir", default=None)
    p.add_argument("--embeds_backend", default="dummy", choices=["colabfold", "dummy"],
                   help="conditioning embeddings for the training sequences")
    p.add_argument("--cache_embeds_dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where training runs; cuda raises when no GPU is visible")
    p.add_argument("--mesh", default=None,
                   help="e.g. data=4,model=2: DP+TP over data*model local ranks "
                        "(one GPU each with --device cuda; gloo ranks with --device cpu)")
    return p


def parse_mesh(spec: str) -> tuple[int, int]:
    """``(data, model)`` from ``--mesh``'s ``data=N,model=M`` (either may be
    left out), as the JAX CLI reads it."""
    axes = dict(kv.split("=") for kv in spec.split(","))
    if set(axes) - {"data", "model"}:
        raise SystemExit(f"--mesh {spec!r}: the axes are data and model")
    data, model = int(axes.get("data", 1)), int(axes.get("model", 1))
    if data < 1 or model < 1:
        raise SystemExit(f"--mesh {spec!r}: each axis needs at least one rank")
    return data, model


def _default_config_yaml(model_cfg: dict, sdes) -> str:
    """Reference-format config.yaml for the trained model (the keys
    ``load_bundle`` reads), written by ``yaml.safe_dump`` so every float
    reads back as a float."""
    import yaml

    so3 = sdes.node_orientations
    cfg = {
        "score_model": {
            "_target_": "bioemu.shortcuts.DiGConditionalScoreModel",
            **{k: model_cfg[k] for k in (
                "dim_hidden", "dim_model", "dim_pair", "dropout", "num_heads", "num_layers"
            )},
        },
        "sdes": {
            "node_orientations": {
                "_target_": "bioemu.shortcuts.DiGSO3SDE",
                "eps_t": float(so3.eps_t),
                "l_max": int(so3.l_max),
                "num_omega": len(so3.omega_grid),
                "num_sigma": len(so3.sigma_grid),
                "sigma_max": float(so3.sigma_max),
                "sigma_min": float(so3.sigma_min),
                "tol": float(so3.tol),
            },
            "pos": {"_target_": "bioemu.shortcuts.CosineVPSDE", "s": float(sdes.pos.s)},
        },
    }
    return yaml.safe_dump(cfg, sort_keys=False)


def _model_config(args) -> tuple[dict, dict | None]:
    """The score net's config and, with ``--model_config_path``, the YAML."""
    import yaml

    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL

    if not args.model_config_path:
        return dict(BIOEMU_V1_MODEL), None
    with open(args.model_config_path) as f:
        cfg_yaml = yaml.safe_load(f)
    return {k: v for k, v in cfg_yaml["score_model"].items() if k != "_target_"}, cfg_yaml


def _check_mesh(model_cfg: dict, data: int, model: int, device: str,
                dtype: str = "float32") -> list[str]:
    """The ranks' devices for a ``data x model`` mesh; raises, before any
    rank starts, when ``model`` does not divide the heads, when the card's
    kernels refuse a rank's heads (``check_card_widths`` at H/M heads of the
    model's width in the model dtype ``dtype``: at 1 and 2 heads the card
    takes f32 only) or when ``device`` is cuda and fewer GPUs are visible
    than there are ranks."""
    import torch

    from se3diff_torch.ops.ipa_attention import check_card_widths

    heads = int(model_cfg.get("num_heads", 32))
    dim_model = int(model_cfg.get("dim_model", 512))
    if heads % model:
        raise SystemExit(f"--mesh model={model} does not divide the model's {heads} heads")
    try:
        check_card_widths({**model_cfg, "num_heads": heads // model,
                           "dim_model": dim_model // model}, device, getattr(torch, dtype))
    except ValueError as e:
        raise SystemExit(f"--mesh model={model} leaves each rank {heads // model} heads: "
                         f"{e}") from None
    world = data * model
    if device == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < world:
            raise SystemExit(f"--mesh data={data},model={model} needs {world} GPUs (one a "
                             f"rank) but only {visible} are visible")
        return [f"cuda:{r}" for r in range(world)]
    return ["cpu"] * world


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.mesh is None:
        run(args)
        return
    from se3diff_torch.parallel import launch, programs

    data, model = parse_mesh(args.mesh)
    if args.batch_size < data:
        raise SystemExit(f"--batch_size {args.batch_size} cannot split over --mesh data={data}")
    devices = _check_mesh(_model_config(args)[0], data, model, args.device, args.dtype)
    logger.info("mesh data=%d, model=%d over %d ranks (%s)", data, model, data * model,
                ", ".join(devices))
    launch.run_ranks(programs.train_rank, data * model, devices,
                     args=(list(sys.argv[1:] if argv is None else argv), data, model))


def run(args: argparse.Namespace, mesh=None) -> list[float]:
    """Train as ``args`` say, on one device, or with ``mesh`` (a
    :class:`~se3diff_torch.parallel.mesh.MeshContext`) as one rank of it on
    the rank's device (every rank calls this together). Returns the logged
    global losses."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from se3diff_torch.diffusion.denoise import SDEs
    from se3diff_torch.models.convert import load_checkpoint
    from se3diff_torch.models.dig import DiGConditionalScoreModel, count_params, init_weights
    from se3diff_torch.ops.ipa_attention import check_card_widths
    from se3diff_torch.parallel.sharding import gather_state_dict, shard_state_dict
    from se3diff_torch.sampling.bundle import instantiate, resolve_device
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.training.data import MultiEnsembleDataset
    from se3diff_torch.training.loop import TrainConfig, train_dsm

    model_cfg, cfg_yaml = _model_config(args)
    writer = mesh is None or mesh.rank == 0
    # Widths the card's kernels refuse fail here, not at the first launch.
    if mesh is None:
        check_card_widths(model_cfg, args.device,
                          torch.bfloat16 if args.dtype == "bfloat16" else torch.float32)
        device = resolve_device(args.device)
    else:
        device = mesh.device
    tops = args.topology or [None] * len(args.trajectory)
    if len(tops) != len(args.trajectory):
        raise SystemExit("--topology count must match --trajectory count")
    if mesh is not None and mesh.rank != 0:
        dist.barrier()  # rank 0 fills the embeddings cache first
    mds = MultiEnsembleDataset.from_trajectories(
        list(zip(args.trajectory, tops)), bucket=args.bucket,
        embeds_backend=args.embeds_backend, cache_embeds_dir=args.cache_embeds_dir,
    )
    if mesh is not None and mesh.rank == 0:
        dist.barrier()
    if writer:
        logger.info("%d ensembles, %d frames, buckets %s",
                    len(mds.datasets), mds.num_frames, mds.occupied_buckets())
    # The per-system conditioning goes to the device once, unbatched.
    batch_fn = mds.batch_fn(args.batch_size, seed=args.seed, device=device)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    so3_kw = {"device": device}
    if args.so3_cache_dir:
        so3_kw["cache_dir"] = args.so3_cache_dir
    tp = None if mesh is None else mesh.tp

    def build(tp):
        if cfg_yaml is not None:
            return instantiate(cfg_yaml["score_model"], dtype=dtype, tp=tp)
        return DiGConditionalScoreModel(**model_cfg, dtype=dtype, tp=tp)

    if cfg_yaml is not None:
        sdes = SDEs(
            pos=instantiate(cfg_yaml["sdes"]["pos"]),
            node_orientations=instantiate(cfg_yaml["sdes"]["node_orientations"], **so3_kw),
        )
    else:
        sdes = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(sigma_max=2.33, **so3_kw))

    model = build(None)
    if args.init_ckpt_path:
        model.load_state_dict(load_checkpoint(args.init_ckpt_path), strict=True)
        if writer:
            logger.info("warm start from %s", args.init_ckpt_path)
    else:
        init_weights(model, torch.Generator().manual_seed(args.seed))
    if writer:
        logger.info("score net: %.1fM params", count_params(model) / 1e6)
    if tp is not None:  # every rank builds the full weights and keeps its shard
        full = model.state_dict()
        model = build(tp)
        model.load_state_dict(shard_state_dict(full, mesh.model_rank, mesh.model), strict=True)
    model.to(device)

    cfg = TrainConfig(
        num_steps=args.steps, lr=args.lr, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, min_t=args.min_t,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        ckpt_dir=args.ckpt_dir, log_every=args.log_every, seed=args.seed,
    )
    model, history = train_dsm(sdes, model, batch_fn, cfg, mesh=mesh)
    if history and writer:
        logger.info("loss: %.4f -> %.4f", history[0], history[-1])

    if args.ckpt_dir:
        sd = model.state_dict() if tp is None else gather_state_dict(model.state_dict(),
                                                                     mesh.model_group)
        if writer:
            out = Path(args.ckpt_dir) / "params.npz"
            out.parent.mkdir(parents=True, exist_ok=True)
            np.savez(out, **{k: v.detach().float().cpu().numpy() for k, v in sd.items()})
            # config.yaml beside it: load_bundle reads the pair with no extra flags.
            cfg_out = out.parent / "config.yaml"
            if args.model_config_path:
                if Path(args.model_config_path).resolve() != cfg_out.resolve():
                    shutil.copy(args.model_config_path, cfg_out)
            else:
                cfg_out.write_text(_default_config_yaml(model_cfg, sdes))
            logger.info("exported %s + config.yaml (reference state-dict layout)", out)
        if mesh is not None:
            dist.barrier()
    return history


if __name__ == "__main__":
    main()
