"""CLI: property-guided PPFT fine-tuning.

Counterpart of ``python -m se3diff_tpu.finetune`` (reference
`bioemu/src/bioemu/finetune.py:695-781`):

    python -m se3diff_torch.finetune --csv_path train.csv --csv_path_val val.csv \\
        --sequence_col seq --h_stars_cols f_dg_pred --h_stars_from_dg \\
        --ckpt_path /path/checkpoint.ckpt --output_dir finetune_out/ [--device cuda]

Runs on the GPU unless ``--device cpu`` is given; ``--dtype`` is the frozen
score model's compute dtype (the control net runs in float32). On the GPU
every attention runs the IPA CUDA kernel: the score model's with the
streamed pair bias, the control net's with the pair bias computed in the
kernel. The CSVs follow the ``reference_h/*_high_confidence.csv`` format;
pass already-sigmoid h* columns, or ``--h_stars_from_dg`` to apply
``sigmoid(-dg)`` to free-energy columns (observables.py:457-480). The config
next to the checkpoint (or ``--model_config_path``) must hold a
``finetune_model`` block beside ``score_model``.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m se3diff_torch.finetune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--csv_path", required=True)
    p.add_argument("--csv_path_val", required=True)
    p.add_argument("--sequence_col", default="seq")
    p.add_argument("--h_stars_cols", nargs="+", required=True)
    p.add_argument("--h_stars_from_dg", action="store_true",
                   help="columns are free energies; use sigmoid(-dg) targets")
    p.add_argument("--ckpt_path", default=None,
                   help="score-model checkpoint (.ckpt/.pt/.npz; required unless "
                        "--model_name is given)")
    p.add_argument("--model_name", default=None,
                   help="pretrained model to fetch from the HuggingFace hub; requires "
                        "network egress. Ignored when --ckpt_path is given.")
    p.add_argument("--model_config_path", default=None)
    p.add_argument("--finetune_ckpt_path", default=None,
                   help="control-net weights (.npz of either package, or .pt)")
    p.add_argument("--finetune_config_path", default=None,
                   help="YAML of trainer hyperparameters (config/finetune/finetune.yaml "
                        "format); explicit flags below override its values")
    p.add_argument("--denoiser_config_path", default=None,
                   help="finetune-recorder YAML (config/denoiser/*_finetune.yaml format); "
                        "overrides --denoiser_type")
    p.add_argument("--h_func_config_path", default=None,
                   help="h-function YAML (config/h_func/*.yaml format); overrides --h_func")
    p.add_argument("--denoiser_type", default="heun_finetune",
                   choices=["heun_finetune", "euler_maruyama_finetune",
                            "sde_dpm_solver_finetune"])
    p.add_argument("--h_func", default="folding_stability",
                   choices=["folding_stability", "folding_binding"])
    p.add_argument("--h_func_ref_path", default=None, help="reference PDB for the h function")
    p.add_argument("--output_dir", default="finetune_out")
    p.add_argument("--cache_embeds_dir", default=None)
    p.add_argument("--embeds_backend", default="colabfold", choices=["colabfold", "dummy"])
    p.add_argument("--msa_file", default=None,
                   help="wild-type A3M MSA reused for every mutant in the CSV (query row "
                        "swapped per sequence; finetune.py:299-322)")
    p.add_argument("--msa_host_url", default=None)
    p.add_argument("--so3_cache_dir", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_steps", type=int, default=None,
                   help="override the recorder's diffusion step count")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lambda_", type=float, default=None)
    p.add_argument("--debug_dump_dir", default=None,
                   help="refresh this dir with each training path's endpoint batch (npz + "
                        "topology.pdb + samples.xtc; finetune.py:419-448)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of the frozen score model")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where fine-tuning runs; cuda raises when no GPU is visible")
    return p


def _h_func_from_yaml(path: str) -> tuple[str, dict]:
    """config/h_func/*.yaml: a ``_target_`` class and its constructor kwargs."""
    import dataclasses

    import yaml

    from se3diff_torch.ppft.h_functions import H_FUNCTIONS

    with open(path) as f:
        h_cfg = yaml.safe_load(f) or {}
    by_class = {cls.__name__: name for name, cls in H_FUNCTIONS.items()}
    if "_target_" not in h_cfg:
        raise SystemExit(f"--h_func_config_path {path}: missing _target_ "
                         f"(expected one of {sorted(by_class)})")
    target = h_cfg.pop("_target_").rsplit(".", 1)[-1]
    if target not in by_class:
        raise SystemExit(f"--h_func_config_path: unknown _target_ {target!r}; "
                         f"known h functions: {sorted(by_class)}")
    name = by_class[target]
    # The reference yamls carry cache_embeds_dir, an embeds-layer concern.
    h_cfg.pop("cache_embeds_dir", None)
    fields = {f.name for f in dataclasses.fields(H_FUNCTIONS[name])}
    unknown = set(h_cfg) - fields
    if unknown:
        raise SystemExit(f"--h_func_config_path: unknown kwargs {sorted(unknown)} for "
                         f"{target} (accepts {sorted(fields)})")
    return name, h_cfg


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    import functools

    import torch
    import yaml

    from se3diff_torch.ppft.trainer import FinetuneConfig, finetune, load_finetune_bundle
    from se3diff_torch.sampling.bundle import make_denoiser

    if args.ckpt_path is None:
        if args.model_name is None:
            raise SystemExit("pass --ckpt_path or --model_name")
        from se3diff_torch.sampling.bundle import maybe_download_checkpoint

        # An explicit --model_config_path wins over the hub's config.
        ckpt, hub_cfg = maybe_download_checkpoint(model_name=args.model_name)
        args.ckpt_path = ckpt
        if args.model_config_path is None:
            args.model_config_path = hub_cfg

    h_func, h_func_kwargs = args.h_func, {}
    if args.h_func_config_path:
        h_func, h_func_kwargs = _h_func_from_yaml(args.h_func_config_path)
    if args.h_func_ref_path:
        h_func_kwargs["ref_path"] = args.h_func_ref_path

    bundle = load_finetune_bundle(
        ckpt_path=args.ckpt_path,
        model_config_path=args.model_config_path,
        finetune_ckpt_path=args.finetune_ckpt_path,
        denoiser_type=args.denoiser_type,
        h_func=h_func,
        h_func_kwargs=h_func_kwargs,
        so3_cache_dir=args.so3_cache_dir,
        seed=args.seed,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=args.device,
    )
    if args.denoiser_config_path:
        with open(args.denoiser_config_path) as f:
            den_cfg = yaml.safe_load(f)
        try:
            den = make_denoiser(den_cfg)
        except KeyError as exc:
            raise SystemExit(f"--denoiser_config_path: {exc.args[0]}; the port records paths "
                             "with heun_denoiser_finetune, euler_maruyama_predictor_finetune "
                             "or sde_dpm_solver_finetune") from None
        # Fine-tuning needs a path recorder; a sampling denoiser has another
        # interface and would fail deep inside the path sampler.
        if not den.func.__name__.endswith("_finetune"):
            raise SystemExit(
                "--denoiser_config_path must name a *_finetune path recorder "
                "(euler_maruyama_predictor_finetune, heun_denoiser_finetune, "
                "sde_dpm_solver_finetune); "
                f"got {den.func.__name__}"
            )
        bundle = bundle._replace(denoiser=den)
    if args.num_steps is not None:
        bundle = bundle._replace(
            denoiser=functools.partial(bundle.denoiser, num_steps=args.num_steps)
        )

    config = FinetuneConfig()
    if args.finetune_config_path:
        # Reference finetune.yaml keys without an equivalent here: _target_
        # (hydra), num_workers (torch DataLoader) and micro_batch_size (the
        # replay is checkpointed a step at a time instead).
        skip = {"_target_", "num_workers", "micro_batch_size"}
        with open(args.finetune_config_path) as f:
            for k, v in (yaml.safe_load(f) or {}).items():
                if k in skip:
                    continue
                if not hasattr(config, k):
                    raise SystemExit(f"--finetune_config_path: unknown key {k!r} "
                                     f"(valid: {sorted(vars(config))})")
                setattr(config, k, tuple(v) if isinstance(v, list) else v)
    for name in ("batch_size", "num_epochs", "lr", "lambda_", "debug_dump_dir"):
        val = getattr(args, name)
        if val is not None:
            setattr(config, name, val)

    finetune(
        csv_path=args.csv_path,
        csv_path_val=args.csv_path_val,
        sequence_col=args.sequence_col,
        h_stars_cols=args.h_stars_cols,
        bundle=bundle,
        config=config,
        output_dir=args.output_dir,
        cache_embeds_dir=args.cache_embeds_dir,
        embeds_backend=args.embeds_backend,
        msa_file=args.msa_file,
        msa_host_url=args.msa_host_url,
        seed=args.seed,
        h_stars_from_dg=args.h_stars_from_dg,
    )


if __name__ == "__main__":
    main()
