"""Worked example: the SO(3) IGSO(3)-mixture toy on the PyTorch port
(counterpart of ``examples/toy_so3.py``; reference se3diff.ipynb).

Trains a score network on a 3-component IGSO(3) mixture by denoising score
matching, samples it back with the Euler–Maruyama reverse SDE, then
PPFT-fine-tunes the component weights toward a new target (the paper's
Milestone 1-2; mixture parameters from se3diff.ipynb cell 2, finetune target
w* = (0.4, 0.2, 0.4)).

Run:  python examples/torch_toy_so3.py [--quick] [--device cuda|cpu]
Writes ``toy_so3_marginals.png`` comparing the analytic angle-marginal pdf
against histograms of base and fine-tuned samples (``--no_plot`` skips it,
and with it the matplotlib import).

``main`` returns the trained models, the samples, their component weights
and the walls of each stage; ``chip_smoke.py`` phase 16 runs it on the card
and checks that the toy learns.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Allow running straight from a repo checkout: python examples/torch_toy_so3.py
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from se3diff_torch.ops import so3 as so3_ops  # noqa: E402
from se3diff_torch.toy import (  # noqa: E402
    DiGMixSO3SDE,
    ScoreNet,
    assign_igso3,
    finetune_toy,
    igso3_mixture_marginal_pdf,
    reverse_diffusion,
    reverse_finetune_diffusion,
    train_toy,
)

# Mixture components at I, R_y(pi/2), R_z(pi) (se3diff.ipynb cell 2).
MUS = [[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
       [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
       [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]]]
SIGMAS, WEIGHTS, H_STARS = [0.2, 0.1, 0.3], [0.3, 0.4, 0.3], [0.4, 0.2, 0.4]
ASSIGN_L_MAX = 200
FULL = dict(so3=dict(num_sigma=100, num_omega=1000, l_max=1000), train_steps=1500,
            train_batch=4096, sample_steps=200, ft_steps=150, ft_batch=1024, ft_path_steps=100)
QUICK = dict(so3=dict(num_sigma=32, num_omega=256, l_max=200), train_steps=50,
             train_batch=1024, sample_steps=64, ft_steps=20, ft_batch=512, ft_path_steps=32)
SAMPLE_BATCH = 4096


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true", help="tiny settings for smoke runs")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ft_steps", type=int, default=None,
                   help="fine-tuning optimizer steps (default 150, 20 with --quick)")
    p.add_argument("--so3_cache_dir", default=None)
    p.add_argument("--out", default="toy_so3_marginals.png")
    p.add_argument("--no_plot", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but CUDA is not available (use --device cpu)")
    s = dict(QUICK if args.quick else FULL)
    if args.ft_steps is not None:
        s["ft_steps"] = args.ft_steps
    device = args.device

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    mus, sigmas, weights, h_stars = (f32(x) for x in (MUS, SIGMAS, WEIGHTS, H_STARS))
    t_start = time.perf_counter()
    sde = DiGMixSO3SDE(**s["so3"], cache_dir=args.so3_cache_dir, device=device)
    t_tables = time.perf_counter() - t_start
    torch.manual_seed(0)  # the two ScoreNets' initial weights
    model, ft_model = ScoreNet(), ScoreNet()
    gen = torch.Generator(device=device).manual_seed(0)

    (model, losses), t_train = timed(lambda: train_toy(
        gen, sde, model, mus, sigmas, weights, num_steps=s["train_steps"],
        batch_size=s["train_batch"], device=device))
    print(f"train: loss {float(losses[0]):.3f} -> {float(losses[-1]):.3f} ({t_train:.1f} s)")
    (xs, _), t_base = timed(lambda: reverse_diffusion(gen, sde, model, SAMPLE_BATCH, s["sample_steps"]))
    base_w = assign_igso3(xs[-1], mus, sigmas, weights, l_max=ASSIGN_L_MAX).mean(0)
    print("sampled component weights:", np.round(base_w.cpu().numpy(), 3),
          "target:", np.asarray(WEIGHTS))

    ft = dict(num_steps_opt=s["ft_steps"], batch_size=s["ft_batch"], num_steps=s["ft_path_steps"],
              l_max=ASSIGN_L_MAX)
    (ft_model, ft_losses), t_ft = timed(lambda: finetune_toy(
        gen, sde, model, ft_model, mus, sigmas, h_stars, **ft, device=device))
    print(f"finetune: loss {float(ft_losses[0]):.4f} -> {float(ft_losses[-1]):.4f} ({t_ft:.1f} s)")
    path, t_ft_sample = timed(lambda: reverse_finetune_diffusion(
        gen, sde, model, ft_model, SAMPLE_BATCH, s["sample_steps"]))
    ft_w = assign_igso3(path[0][-1], mus, sigmas, weights, l_max=ASSIGN_L_MAX).mean(0)
    print("fine-tuned component weights:", np.round(ft_w.cpu().numpy(), 3),
          "target h*:", np.asarray(H_STARS))
    wall = time.perf_counter() - t_start

    if not args.no_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        omega, pdf = igso3_mixture_marginal_pdf(mus, sigmas, weights, l_max=ASSIGN_L_MAX)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(omega.cpu().numpy(), pdf.cpu().numpy(), label="analytic mixture pdf")
        for name, samples in [("base", xs[-1]), ("fine-tuned", path[0][-1])]:
            angles = so3_ops.angle_from_rotmat(samples)[0].cpu().numpy()
            ax.hist(angles, bins=80, density=True, alpha=0.4, label=f"{name} samples")
        ax.set_xlabel("rotation angle")
        ax.set_ylabel("density")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.out, dpi=120)
        print("wrote", args.out)

    return dict(settings=s, sde=sde, model=model, ft_model=ft_model, gen=gen, mus=mus,
                sigmas=sigmas, weights=weights, h_stars=h_stars, losses=losses,
                ft_losses=ft_losses, xs=xs, path=path, base_w=base_w, ft_w=ft_w,
                t_tables=t_tables, t_train=t_train, t_base=t_base, t_ft=t_ft,
                t_ft_sample=t_ft_sample, wall=wall)


if __name__ == "__main__":
    main()
