"""CLI: sample protein conformational ensembles from sequence.

Counterpart of ``python -m se3diff_tpu.sample`` (reference
`bioemu/src/bioemu/sample.py:330-397`):

    python -m se3diff_torch.sample --sequence <seq-or-fasta> --num_samples 100 \\
        --output_dir out/ --ckpt_path /path/checkpoint.ckpt [--device cuda]

Runs on the GPU unless ``--device cpu`` is given. Checkpoints are local
paths; the bioemu-v1.0 ``config.yaml`` format drives model/SDE
construction. ``--embeds_backend dummy`` substitutes deterministic
embeddings when no ColabFold install is available.

``--sp N`` runs sequence-parallel over N local ranks, spawned processes
joined by a ``file://`` rendezvous: with ``--device cuda`` one GPU each
(NCCL; N GPUs must be visible), with ``--device cpu`` N gloo ranks on the
CPU. Rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import logging

from se3diff_torch.sampling.bundle import load_bundle, make_denoiser, random_bundle
from se3diff_torch.sampling.pipeline import sample


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m se3diff_torch.sample", description=__doc__)
    p.add_argument("--sequence", required=True, help="amino-acid sequence, or fasta path")
    p.add_argument("--num_samples", type=int, required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size_100", type=int, default=10,
                   help="batch size at L=100; scaled by (100/L)^2 (sample.py:279)")
    p.add_argument("--ckpt_path", default=None, help="torch checkpoint path")
    p.add_argument("--model_name", default=None,
                   help="pretrained model to fetch from the HuggingFace hub "
                        "(e.g. bioemu-v1.0); requires network egress. Ignored "
                        "when --ckpt_path is given.")
    p.add_argument("--model_config_path", default=None,
                   help="config.yaml (default: alongside the checkpoint)")
    p.add_argument("--denoiser", default="dpm",
                   choices=["dpm", "dpm_fast", "dpm_2m", "heun", "euler_maruyama"],
                   help="denoiser config (config/denoiser/*.yaml defaults; "
                        "dpm_2m = multistep DPM-Solver++(2M))")
    p.add_argument("--denoiser_config_path", default=None,
                   help="reference-format denoiser yaml overriding --denoiser")
    p.add_argument("--cache_embeds_dir", default=None)
    p.add_argument("--embeds_backend", default="colabfold", choices=["colabfold", "dummy"])
    p.add_argument("--msa_file", default=None,
                   help="A3M MSA to use instead of querying an MSA server; its "
                        "query row is replaced by --sequence (get_embeds.py:225-235)")
    p.add_argument("--msa_host_url", default=None)
    p.add_argument("--so3_cache_dir", default=None)
    p.add_argument("--filter_samples", action=argparse.BooleanOptionalAction,
                   default=True, help="drop unphysical frames before writing")
    # Named so the abbreviation "--batch_size" still resolves to --batch_size_100.
    p.add_argument("--exact_batch_size", type=int, default=None,
                   help="exact per-batch sample count, overriding the quadratic "
                        "--batch_size_100 heuristic")
    p.add_argument("--length_bucket", type=int, default=None,
                   help="pad L to this multiple (masked)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; cuda raises when no GPU is visible")
    p.add_argument("--sp", type=int, default=0,
                   help="sequence-parallel degree: N local ranks, each holding a slab "
                        "of the query rows of the LxL pair tensors (one GPU each with "
                        "--device cuda; gloo ranks with --device cpu)")
    return p


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.ckpt_path is None and args.model_name is not None:
        from se3diff_torch.sampling.bundle import maybe_download_checkpoint

        ckpt, hub_cfg = maybe_download_checkpoint(model_name=args.model_name)
        args.ckpt_path = ckpt
        if args.model_config_path is None:
            args.model_config_path = hub_cfg

    if args.sp > 1:
        import torch

        from se3diff_torch.parallel import launch

        if args.device == "cuda":
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if visible < args.sp:
                raise SystemExit(f"--sp {args.sp} requested but only {visible} GPUs are visible")
            devices = [f"cuda:{r}" for r in range(args.sp)]
        else:
            devices = ["cpu"] * args.sp
        logging.info("sequence parallelism over %d ranks (%s)", args.sp, ", ".join(devices))
        launch.run_ranks(_run, args.sp, devices, args=(args,))
        return
    _run(None, args)


def _run(sp, args: argparse.Namespace) -> None:
    """Build the bundle and sample; ``sp`` is the rank's context under
    ``--sp`` (the spawned ranks call this), None otherwise."""
    import torch

    if sp is not None:
        logging.basicConfig(level=logging.INFO)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    device = args.device if sp is None else sp.device

    denoiser: str | dict = args.denoiser
    if args.denoiser_config_path:
        import yaml

        with open(args.denoiser_config_path) as f:
            denoiser = yaml.safe_load(f)

    if args.ckpt_path is None:
        logging.warning(
            "No --ckpt_path given: using a randomly initialised bioemu-v1.0-sized "
            "model (useful only for smoke tests)."
        )
        bundle = random_bundle(denoiser=args.denoiser, dtype=dtype, device=device, sp=sp)
        if not isinstance(denoiser, str):
            bundle.denoiser = make_denoiser(denoiser)
    else:
        bundle = load_bundle(
            args.ckpt_path,
            config_path=args.model_config_path,
            denoiser=denoiser,
            so3_cache_dir=args.so3_cache_dir,
            dtype=dtype,
            device=device,
            sp=sp,
        )

    sample(
        sequence=args.sequence,
        num_samples=args.num_samples,
        output_dir=args.output_dir,
        bundle=bundle,
        batch_size_100=args.batch_size_100,
        cache_embeds_dir=args.cache_embeds_dir,
        embeds_backend=args.embeds_backend,
        msa_file=args.msa_file,
        msa_host_url=args.msa_host_url,
        filter_samples=args.filter_samples,
        length_bucket=args.length_bucket,
        batch_size=args.exact_batch_size,
    )


if __name__ == "__main__":
    main()
