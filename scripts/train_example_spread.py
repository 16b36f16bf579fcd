"""Spread of the training example's known-answer statistic over seeds, in
either package.

Trains the example's score net (``examples/train_from_scratch.py`` with
``--package jax``, on the CPU; ``examples/torch_train_from_scratch.py`` with
``--package torch``) for ``--steps`` DSM steps from each of ``--seeds``
seeds (the initial weights' key or generator and the training noise's seed)
and samples it with Euler–Maruyama from ``--samples`` sampling seeds; prints
the samples' mean pairwise Ca distance for each, the mean of each seed and
the mean over all. Only the asked-for package is imported, but for
``--package cross``: JAX's model of each seed sampled by both packages'
Euler–Maruyama (the port's on JAX's weights, carried across by
``models.convert.state_dict_from_jax``, on the CPU), one line a sampler.

    python scripts/train_example_spread.py --package jax [--seeds 4] [--samples 8] [--dim_model 32]
    python scripts/train_example_spread.py --package torch [--device cuda|cpu] [--dim_model 64]
    python scripts/train_example_spread.py --package cross [--seeds 1] [--samples 48]

``--dim_model 32`` is the JAX example's width (4 heads of 8).
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _jax_seeds(args, cross=False):
    """For each seed: the trained model's ``draw(k)``, the mean pairwise
    distance of the samples from sampling key 42 + k (JAX package); with
    ``cross`` also the port's ``draw(k)`` of the same weights (generator
    42 + k), yielded after it."""
    import runpy

    import jax
    import jax.numpy as jnp
    import numpy as np

    from se3diff_tpu.diffusion import denoise
    from se3diff_tpu.models.dig import DiGConditionalScoreModel
    from se3diff_tpu.sde.so3_sde import DiGSO3SDE
    from se3diff_tpu.sde.vpsde import CosineVPSDE
    from se3diff_tpu.training.loop import TrainConfig, train_dsm

    ex = runpy.run_path(os.path.join(REPO, "examples", "train_from_scratch.py"), run_name="example")
    _, batch_fn = ex["make_dataset"](np.random.default_rng(0))
    model = DiGConditionalScoreModel(num_layers=2, dim_model=args.dim_model, dim_pair=16, num_heads=4,
                                     dim_hidden=64, dropout=0.0)
    sdes = denoise.SDEs(pos=CosineVPSDE(),
                        node_orientations=DiGSO3SDE(num_sigma=32, num_omega=256, l_max=500))
    b = batch_fn(0)
    for seed in range(args.seeds):
        params = model.init(jax.random.key(seed), b["pos"][:1], b["rot"][:1],
                            jnp.ones((1,), jnp.float32), b["single"][:1], b["pair"][:1])
        params, _ = train_dsm(sdes, model.apply, params, batch_fn, _config(TrainConfig, args, seed, 0.05))
        sample = jax.jit(lambda k, params=params: denoise.euler_maruyama(
            k, sdes, lambda pos, rot, t: model.apply(params, pos, rot, t, b["single"], b["pair"]),
            batch=8, length=8, num_steps=100, min_t=0.05)[0])
        yield lambda k: ex["mean_pairwise_dist"](np.asarray(sample(jax.random.key(42 + k))))
        if cross:
            yield _port_sampler(params, b, args.dim_model)


def _port_sampler(params, b, dim_model):
    """The port's ``draw(k)`` of JAX's trained weights ``params`` on the CPU:
    the samples' mean pairwise distance from generator 42 + k."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "examples"))
    import torch_train_from_scratch as ex
    from se3diff_torch.diffusion import denoise
    from se3diff_torch.models.convert import state_dict_from_jax
    from se3diff_torch.models.dig import DiGConditionalScoreModel
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE

    model = DiGConditionalScoreModel(**dict(ex.JAX_MODEL, dim_model=dim_model))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**ex.SO3, device="cpu"))
    single, pair = (torch.from_numpy(np.array(b[k])) for k in ("single", "pair"))

    def draw(k):
        with torch.no_grad():
            pos, _ = denoise.euler_maruyama(
                torch.Generator().manual_seed(42 + k), sdes,
                lambda x, r, t: model(x, r, t, single, pair), batch=8, length=8,
                num_steps=ex.SAMPLE_STEPS, min_t=ex.MIN_T)
        return ex.mean_pairwise_dist(pos.numpy())

    return draw


def _torch_seeds(args):
    """The same for the PyTorch port, on ``args.device``."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "examples"))
    import torch_train_from_scratch as ex
    from se3diff_torch.diffusion import denoise
    from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights
    from se3diff_torch.ops.ipa_attention import check_card_widths
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.training.loop import TrainConfig, train_dsm

    cfg_model = dict(ex.JAX_MODEL, dim_model=args.dim_model)
    check_card_widths(cfg_model, args.device, torch.float32)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but CUDA is not available (use --device cpu)")
    _, batch_fn = ex.make_dataset(np.random.default_rng(0))
    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**ex.SO3, device=args.device))
    b = batch_fn(0)
    single, pair = (torch.from_numpy(np.ascontiguousarray(b[k])).to(args.device) for k in ("single", "pair"))
    for seed in range(args.seeds):
        model = init_weights(DiGConditionalScoreModel(**cfg_model),
                             torch.Generator().manual_seed(seed)).to(args.device)
        model, _ = train_dsm(sdes, model, batch_fn, _config(TrainConfig, args, seed, ex.MIN_T))
        model.eval()

        def draw(k, model=model):
            with torch.no_grad():
                pos, _ = denoise.euler_maruyama(
                    torch.Generator(device=args.device).manual_seed(42 + k), sdes,
                    lambda x, r, t: model(x, r, t, single, pair), batch=8, length=8,
                    num_steps=ex.SAMPLE_STEPS, min_t=ex.MIN_T)
            return ex.mean_pairwise_dist(pos.cpu().numpy())

        yield draw


def _config(TrainConfig, args, seed, min_t):
    return TrainConfig(num_steps=args.steps, lr=2e-3, warmup_steps=min(20, args.steps // 4),
                       min_t=min_t, log_every=max(args.steps // 10, 1), seed=seed)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--package", required=True, choices=["jax", "torch", "cross"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="--package torch only")
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--dim_model", type=int, default=32)
    args = p.parse_args(argv)

    import numpy as np

    cross = args.package == "cross"
    seeds = (_jax_seeds(args, cross) if args.package != "torch" else _torch_seeds(args))
    means = {}
    for n, draw in enumerate(seeds):
        seed, sampler = (n // 2, ("jax", "port")[n % 2]) if cross else (n, args.package)
        d = [draw(k) for k in range(args.samples)]
        means.setdefault(sampler, []).append(float(np.mean(d)))
        print(f"seed {seed}{f' ({sampler} sampler)' if cross else ''}: "
              + " ".join(f"{x:.3f}" for x in d) + f"; mean {means[sampler][-1]:.4f}", flush=True)
    where = "cpu" if args.package != "torch" else args.device
    for sampler, m in means.items():
        print(f"{args.package} dim_model {args.dim_model} on {where}"
              + (f", {sampler} sampler" if cross else "")
              + f": mean over {args.seeds} seeds x {args.samples} samples {np.mean(m):.4f}")


if __name__ == "__main__":
    main()
