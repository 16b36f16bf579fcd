"""Toy SO(3) diffusion training: DSM loss and reverse sampling.

Counterpart of ``se3diff_tpu/toy/train.py`` (reference `se3diff/train.py`).
Every drawing function is split into its draws and a deterministic core that
takes them, so tests can feed it the JAX package's draws:
:func:`reverse_diffusion` draws the prior and calls
:func:`reverse_diffusion_from`, whose step noise is a generator, the normals
``[T, B, 3]`` or a callable (``predictors.standard_normal``);
:func:`compute_train_loss` draws ``(x_0, t, x_t)`` and calls
:func:`train_loss_from_draws`. The loops run eagerly on the SDE's device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from se3diff_torch.diffusion.predictors import EulerMaruyamaPredictor
from se3diff_torch.ops import igso3 as igso3_ops
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.sampling.bundle import resolve_device
from se3diff_torch.sde.so3_sde import SO3SDE
from se3diff_torch.toy.models import DiGMixSO3SDE

# score_model_fn(rot [B, 3, 3], t [B]) -> raw score [B, 3]
ToyModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# Noise of a reverse loop: a generator, the normals [T, B, 3], or a callable
# like -> z.
StepNoise = torch.Generator | torch.Tensor | Callable[[torch.Tensor], torch.Tensor]
# Draws of a training step: a generator, or a callable step -> (x_0, t, x_t).
TrainDraws = torch.Generator | Callable[[int], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def get_so3_score(
    x_t: torch.Tensor, sde: SO3SDE, model_fn: ToyModelFn, t: torch.Tensor
) -> torch.Tensor:
    """Raw model output * score scaling -> true score (se3diff/train.py:20-37)."""
    return model_fn(x_t, t) * sde.get_score_scaling(t)[..., None]


def timegrid(num_steps: int) -> tuple[torch.Tensor, list[float]]:
    """The reverse grid ``1 -> 0`` in ``num_steps`` (f32) and its steps as
    Python floats."""
    timesteps = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32)
    return timesteps, torch.diff(timesteps).tolist()


def noise_at(noise: StepNoise, idx: int):
    """Step ``idx``'s noise source: its row of the normals, or ``noise``."""
    return noise[idx] if isinstance(noise, torch.Tensor) else noise


def reverse_diffusion(
    generator: torch.Generator,
    sde: SO3SDE,
    model_fn: ToyModelFn,
    batch_size: int = 4096,
    num_steps: int = 200,
) -> tuple[torch.Tensor, torch.Tensor]:
    """EM reverse sampling on SO(3); returns the trajectory ``xs [T+1, B, 3,
    3]`` and ``timesteps [T+1]`` (se3diff/train.py:40-75). Draws the uniform
    prior, then one normal a step, from ``generator``."""
    x_t = sde.prior_sampling(generator, (batch_size, 3, 3))
    return reverse_diffusion_from(x_t, sde, model_fn, generator, num_steps)


@torch.no_grad()
def reverse_diffusion_from(
    x_t: torch.Tensor, sde: SO3SDE, model_fn: ToyModelFn, noise: StepNoise, num_steps: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`reverse_diffusion` from the prior draw ``x_t`` with step noise
    ``noise``."""
    predictor = EulerMaruyamaPredictor(sde, 1.0, 1.0)
    timesteps, dts = timegrid(num_steps)
    xs, x = [x_t], x_t
    for idx in range(num_steps):
        t = torch.full((x.shape[0],), float(timesteps[idx]), device=x.device)
        score = get_so3_score(x, sde, model_fn, t)
        x = predictor.update_given_score(noise_at(noise, idx), x, t, dts[idx], score)[0]
        xs.append(x)
    return torch.stack(xs), timesteps.to(x_t.device)


def igso3_mixture_marginal_pdf(
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    weights: torch.Tensor,
    l_max: int = 1000,
    num_points: int = 1000,
    tol: float = 1e-7,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic angle-marginal pdf of the mixture for plots and tests
    (se3diff/train.py:78-106)."""
    omega = torch.linspace(0.0, math.pi, num_points, dtype=mus.dtype, device=mus.device)
    l_grid = torch.arange(l_max, dtype=omega.dtype, device=omega.device)
    omega_0 = so3_ops.angle_from_rotmat(mus)[0]  # [K]
    pdfs = igso3_ops.igso3_marginal_pdf(
        omega[None, :], omega_0[:, None], sigmas[:, None], l_grid, tol=tol
    )
    return omega, (weights[:, None] * pdfs).sum(0).clamp(min=0.0)


def train_loss_from_draws(
    model_fn: ToyModelFn,
    sde: SO3SDE,
    x_0: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    tol: float = 1e-7,
) -> torch.Tensor:
    """DSM loss on given draws: with ``q_t = Log(x_0^T x_t)``, regress
    ``model(x_t, t) ~ score(q_t, t) / lambda(t)`` (se3diff/train.py:109-143)."""
    q_t = so3_ops.rotmat_to_rotvec(x_0.transpose(-1, -2) @ x_t)
    true_score = sde.compute_score(q_t, t, method="table")
    target = true_score / (sde.get_score_scaling(t)[..., None] + tol)
    return (model_fn(x_t, t) - target).square().mean()


def draw_train_batch(
    generator: torch.Generator,
    sde: DiGMixSO3SDE,
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    weights: torch.Tensor,
    batch_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x_0`` from the mixture, ``t ~ U[0, 1)``, ``x_t ~ p_t(. | x_0)``."""
    x_0 = sde.sample_multiple_igso3(generator, mus, sigmas, weights, batch_size)
    t = torch.rand((batch_size,), generator=generator, device=x_0.device)
    return x_0, t, sde.sample_marginal(generator, x_0, t)


def compute_train_loss(
    generator: torch.Generator,
    sde: DiGMixSO3SDE,
    model_fn: ToyModelFn,
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    weights: torch.Tensor,
    batch_size: int = 4096,
    tol: float = 1e-7,
) -> torch.Tensor:
    """Denoising score-matching loss on the mixture (se3diff/train.py:109-143)."""
    x_0, t, x_t = draw_train_batch(generator, sde, mus, sigmas, weights, batch_size)
    return train_loss_from_draws(model_fn, sde, x_0, x_t, t, tol)


def adamw(model: torch.nn.Module, learning_rate: float) -> torch.optim.AdamW:
    """AdamW with optax.adamw's defaults (weight decay 1e-4, not torch's 1e-2)."""
    return torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def train_toy(
    draws: TrainDraws,
    sde: DiGMixSO3SDE,
    model: torch.nn.Module,
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    weights: torch.Tensor,
    num_steps: int = 500,
    batch_size: int = 4096,
    learning_rate: float = 5e-3,
    device: str | torch.device = "cuda",
) -> tuple[torch.nn.Module, torch.Tensor]:
    """AdamW training of ``model`` (in place) on ``device``, where the SDE's
    tables, the mixture and the model are moved; returns ``(model, losses
    [num_steps])``. Each step's ``(x_0, t, x_t)`` come from ``draws``: a
    generator on ``device``, or a callable ``step -> (x_0, t, x_t)``."""
    device = resolve_device(device)
    sde.to(device)
    model.to(device)
    mus, sigmas, weights = (x.to(device) for x in (mus, sigmas, weights))
    opt = adamw(model, learning_rate)
    losses = []
    for step in range(num_steps):
        if isinstance(draws, torch.Generator):
            batch = draw_train_batch(draws, sde, mus, sigmas, weights, batch_size)
        else:
            batch = tuple(x.to(device) for x in draws(step))
        x_0, t, x_t = batch
        loss = train_loss_from_draws(model, sde, x_0, x_t, t)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return model, torch.stack(losses)
