"""Toy PPFT fine-tuning on the IGSO(3) mixture.

Counterpart of ``se3diff_tpu/toy/finetune.py`` (reference
`se3diff/finetune.py`): record a controlled reverse path without gradients,
re-evaluate the finetune model over the saved path in one batched call, and
assemble the EV + KL stochastic-control loss from ``se3diff_torch.ppft``.
As in ``toy/train.py``, :func:`reverse_finetune_diffusion` draws the prior
and calls :func:`reverse_finetune_diffusion_from`, and
:func:`compute_finetune_loss` draws a path and calls
:func:`finetune_loss_on_path`.
"""

from __future__ import annotations

import torch

from se3diff_torch.diffusion.predictors import EulerMaruyamaPredictor
from se3diff_torch.ops import igso3 as igso3_ops
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.ppft.integrals import compute_int_dws, compute_int_u_u_dt
from se3diff_torch.ppft.losses import compute_ev_loss, compute_kl_loss
from se3diff_torch.sampling.bundle import resolve_device
from se3diff_torch.sde.so3_sde import SO3SDE
from se3diff_torch.toy.train import StepNoise, ToyModelFn, adamw, get_so3_score, noise_at, timegrid

# (xs [T+1, B, 3, 3], timesteps [T+1], us [T, B, 3], dWs [T, B, 3])
ToyPath = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reverse_finetune_diffusion(
    generator: torch.Generator,
    sde: SO3SDE,
    model_fn: ToyModelFn,
    finetune_model_fn: ToyModelFn,
    batch_size: int = 4096,
    num_steps: int = 200,
) -> ToyPath:
    """Controlled EM reverse sampling recording ``(xs, timesteps, us, dWs)``
    (se3diff/finetune.py:17-65). Draws the uniform prior, then one normal a
    step, from ``generator``."""
    x_t = sde.prior_sampling(generator, (batch_size, 3, 3))
    return reverse_finetune_diffusion_from(x_t, sde, model_fn, finetune_model_fn, generator, num_steps)


@torch.no_grad()
def reverse_finetune_diffusion_from(
    x_t: torch.Tensor,
    sde: SO3SDE,
    model_fn: ToyModelFn,
    finetune_model_fn: ToyModelFn,
    noise: StepNoise,
    num_steps: int,
) -> ToyPath:
    """:func:`reverse_finetune_diffusion` from the prior draw ``x_t`` with
    step noise ``noise`` (a generator, the normals ``[T, B, 3]`` or a
    callable)."""
    predictor = EulerMaruyamaPredictor(sde, 1.0, 1.0)
    timesteps, dts = timegrid(num_steps)
    xs, us, dWs, x = [x_t], [], [], x_t
    for idx in range(num_steps):
        t = torch.full((x.shape[0],), float(timesteps[idx]), device=x.device)
        score = get_so3_score(x, sde, model_fn, t)
        u = finetune_model_fn(x, t)
        x, _, dW = predictor.update_given_score(
            noise_at(noise, idx), x, t, dts[idx], score, finetune_score=u
        )
        xs.append(x)
        us.append(u)
        dWs.append(dW)
    return torch.stack(xs), timesteps.to(x_t.device), torch.stack(us), torch.stack(dWs)


def assign_igso3(
    x_0: torch.Tensor,
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    weights: torch.Tensor,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> torch.Tensor:
    """Posterior component responsibilities ``[B, K]`` under the IGSO(3)
    mixture (se3diff/finetune.py:68-92)."""
    x_rel = torch.einsum("kij,bil->bkjl", mus, x_0)  # mu_k^T x_0, [B, K, 3, 3]
    angle = so3_ops.angle_from_rotmat(x_rel)[0]  # [B, K]
    l_grid = torch.arange(l_max, dtype=angle.dtype, device=angle.device)
    pdf = igso3_ops.igso3_expansion(angle, sigmas[None, :], l_grid, tol=tol) * weights
    return pdf / (pdf.sum(-1, keepdim=True) + tol)


def finetune_loss_on_path(
    path: ToyPath,
    finetune_model_fn: ToyModelFn,
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    h_stars: torch.Tensor,
    lambda_: float = 0.1,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> torch.Tensor:
    """EV + lambda * KL loss on a recorded path (se3diff/finetune.py:95-143).

    Gradients flow only through the re-evaluation of the finetune model on
    the saved states, in one call over ``[T * B]``. ``h_stars`` is also the
    prior weight of :func:`assign_igso3`, as in the JAX package.
    """
    xs, timesteps, us_sg, dWs = (x.detach() for x in path)
    T, B = us_sg.shape[:2]
    t_flat = timesteps[:-1].repeat_interleave(B)
    us = finetune_model_fn(xs[:-1].reshape(T * B, 3, 3), t_flat).reshape(T, B, 3)

    hs = assign_igso3(xs[-1], mus, sigmas, h_stars, l_max=l_max, tol=tol)
    dts = torch.diff(timesteps)
    int_u_u_dt = compute_int_u_u_dt(us=us, dts=dts)
    int_u_u_dt_sg = compute_int_u_u_dt(us=us_sg, dts=dts)
    int_dws = compute_int_dws(us=us, dWs=dWs)

    loss_ev = compute_ev_loss(ws=int_dws, hs=hs, h_stars=h_stars, tol=tol)
    loss_kl = compute_kl_loss(ws=int_dws, int_u_u_dt=int_u_u_dt, int_u_u_dt_sg=int_u_u_dt_sg)
    return loss_ev + lambda_ * loss_kl


def compute_finetune_loss(
    generator: torch.Generator,
    sde: SO3SDE,
    model_fn: ToyModelFn,
    finetune_model_fn: ToyModelFn,
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    h_stars: torch.Tensor,
    lambda_: float = 0.1,
    batch_size: int = 4096,
    num_steps: int = 200,
    l_max: int = 1000,
    tol: float = 1e-7,
) -> torch.Tensor:
    """Record a path from ``generator`` and take :func:`finetune_loss_on_path`
    on it."""
    path = reverse_finetune_diffusion(
        generator, sde, model_fn, finetune_model_fn, batch_size, num_steps
    )
    return finetune_loss_on_path(
        path, finetune_model_fn, mus, sigmas, h_stars, lambda_=lambda_, l_max=l_max, tol=tol
    )


def finetune_toy(
    generator: torch.Generator,
    sde: SO3SDE,
    model_fn: ToyModelFn,
    finetune_model: torch.nn.Module,
    mus: torch.Tensor,
    sigmas: torch.Tensor,
    h_stars: torch.Tensor,
    num_steps_opt: int = 100,
    lambda_: float = 0.1,
    batch_size: int = 1024,
    num_steps: int = 100,
    learning_rate: float = 1e-3,
    l_max: int = 1000,
    device: str | torch.device = "cuda",
) -> tuple[torch.nn.Module, torch.Tensor]:
    """AdamW fine-tuning of ``finetune_model`` (in place) on ``device``, where
    the SDE's tables, the mixture and the model are moved (``model_fn`` must
    run there); returns ``(finetune_model, losses [num_steps_opt])``. Paths
    draw from ``generator``, which lives on ``device``."""
    device = resolve_device(device)
    sde.to(device)
    finetune_model.to(device)
    mus, sigmas, h_stars = (x.to(device) for x in (mus, sigmas, h_stars))
    opt = adamw(finetune_model, learning_rate)
    losses = []
    for _ in range(num_steps_opt):
        loss = compute_finetune_loss(
            generator, sde, model_fn, finetune_model, mus, sigmas, h_stars,
            lambda_=lambda_, batch_size=batch_size, num_steps=num_steps, l_max=l_max,
        )
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return finetune_model, torch.stack(losses)
