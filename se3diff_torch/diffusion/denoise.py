"""Reverse-diffusion samplers (Euler–Maruyama, Heun, DPM-Solver-2,
DPM-Solver++(2M), parallel-in-time Picard Euler–Maruyama) and the PPFT path recorders (Euler–Maruyama, Heun and
DPM-Solver-2 with a finetune control).

Counterpart of ``se3diff_tpu/diffusion/denoise.py`` (reference
`bioemu/src/bioemu/denoiser.py:206-777`). Each public function draws the
prior and then runs a private Python loop over the time grid; every step
stays on the device of the prior's generator, with no host synchronisation
inside the loop. The stochastic loops draw their per-step standard normals
from the same generator (positions, then rotations, each step); they also
take the draws as tensors, so tests can feed both packages the same noise.

Model interface: ``model_fn(pos, rot, t) -> (pos_raw, rot_raw)`` with
``pos [B, L, 3]`` (nm), ``rot [B, L, 3, 3]``, ``t [B]``. ``pos_raw`` predicts
``score * std`` and ``rot_raw`` predicts ``score / score_scaling``;
:func:`get_score` converts both to true scores (denoiser.py:169-203).
"""

from __future__ import annotations

import inspect
import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from se3diff_torch.diffusion.predictors import EulerMaruyamaPredictor, standard_normal
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.sde.base import bcast_right
from se3diff_torch.sde.so3_sde import SO3SDE
from se3diff_torch.sde.vpsde import CosineVPSDE

ModelFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]
]


@dataclass(frozen=True)
class SDEs:
    """The two corruption processes (denoiser.py:18-21)."""

    pos: CosineVPSDE
    node_orientations: SO3SDE


class DenoisedSDEPath(NamedTuple):
    """Recorded finetune path (denoiser.py:23-27), densely stacked.

    ``pos_path [T+1, B, L, 3]``, ``rot_path [T+1, B, L, 3, 3]`` include the
    prior sample at index 0; ``timesteps [T+1]``. ``us``/``dWs`` are dicts
    with keys ``pos`` and ``node_orientations``, each ``[T, B, L, 3]``.
    """

    pos_path: torch.Tensor
    rot_path: torch.Tensor
    timesteps: torch.Tensor
    us: dict[str, torch.Tensor]
    dWs: dict[str, torch.Tensor]


def get_score(
    sdes: SDEs, model_fn: ModelFn, pos: torch.Tensor, rot: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Convert raw model outputs to true scores (denoiser.py:169-203)."""
    pos_raw, rot_raw = model_fn(pos, rot, t)
    rot_score = rot_raw * bcast_right(sdes.node_orientations.get_score_scaling(t), rot_raw)
    _, pos_std = sdes.pos.marginal_prob(torch.ones_like(pos_raw), t)
    return pos_raw / pos_std, rot_score


# Production step counts per solver: 30 for DPM-Solver-2 (the reference
# schedule) and 30 for DPM-Solver++(2M) (1 NFE/step).
SOLVER_DEFAULT_STEPS = {"dpm": 30, "dpm_2m": 30}


def resolve_steps(steps: int | None, solver: str) -> int:
    """Explicit ``steps`` wins, else the solver's production default."""
    if steps is not None:
        return steps
    return SOLVER_DEFAULT_STEPS.get(solver, 30)


def _prior(
    generator: torch.Generator, sdes: SDEs, batch: int, length: int, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prior draw on the generator's device: Gaussian positions, then
    Haar-uniform rotations (in that order from one generator)."""
    pos = sdes.pos.prior_sampling(
        generator, (batch, length, 3), dtype=dtype, device=generator.device
    )
    rot = sdes.node_orientations.prior_sampling(generator, (batch, length, 3, 3))
    return pos, rot.to(dtype)


def _timegrid(num_steps: int, max_t: float, min_t: float, dtype=torch.float32):
    """Host-side time grid and its steps, as Python floats of ``dtype``."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    timesteps = torch.linspace(max_t, min_t, num_steps + 1, dtype=dtype)
    return timesteps.tolist(), torch.diff(timesteps).tolist()


def _t_from_lambda(sde: CosineVPSDE, lambda_t: torch.Tensor) -> torch.Tensor:
    """Invert the cosine schedule in ``lambda = log(alpha/sigma)`` space
    (DPM-solver Appendix D.4; denoiser.py:623-631)."""
    f_lambda = -0.5 * torch.log(torch.exp(-2.0 * lambda_t) + 1.0)
    log_c = math.log(math.cos(math.pi * sde.s / 2.0 / (1.0 + sde.s)))
    return 2.0 * (1.0 + sde.s) / math.pi * torch.arccos(torch.exp(f_lambda + log_c)) - sde.s


# Noise of a stochastic loop: a generator (draws positions then rotations at
# each step), the draws themselves, ``(z_pos [T, B, L, 3], z_rot [T, B, L, 3])``,
# or a callable ``like -> z`` (see ``predictors.standard_normal``).
StepNoise = torch.Generator | tuple[torch.Tensor, torch.Tensor] | Callable


def _noise_at(draws: StepNoise, idx: int):
    if isinstance(draws, tuple):
        return draws[0][idx], draws[1][idx]
    return draws, draws


def euler_maruyama(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 200,
    max_t: float = 0.99,
    min_t: float = 0.001,
    noise_weight: float = 1.0,
    marginal_concentration_factor: float = 1.0,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prior sample and ``num_steps`` reverse Euler–Maruyama steps, one model
    evaluation each (denoiser.py:206-264)."""
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _euler_maruyama_loop(
        sdes, model_fn, pos, rot, generator, num_steps, max_t, min_t, noise_weight,
        marginal_concentration_factor, dtype,
    )


def _euler_maruyama_loop(
    sdes, model_fn, pos, rot, draws: StepNoise, num_steps, max_t, min_t, noise_weight,
    marginal_concentration_factor, dtype,
):
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    batch = pos.shape[0]
    em_pos = EulerMaruyamaPredictor(sdes.pos, noise_weight, marginal_concentration_factor)
    em_rot = EulerMaruyamaPredictor(
        sdes.node_orientations, noise_weight, marginal_concentration_factor
    )
    for idx in range(num_steps):
        t = torch.full((batch,), timesteps[idx], dtype=dtype, device=pos.device)
        pos_score, rot_score = get_score(sdes, model_fn, pos, rot, t)
        n_pos, n_rot = _noise_at(draws, idx)
        pos = em_pos.update_given_score(n_pos, pos, t, dts[idx], pos_score)[0]
        rot = em_rot.update_given_score(n_rot, rot, t, dts[idx], rot_score)[0]
    return pos, rot


def _heun_grid(num_steps: int, max_t: float, min_t: float, noise: float, dtype):
    """The time grid and each step's ``(t, t_hat, t_next, dt)`` for Heun's
    churn, as host scalars of the grid's numpy dtype, which is how the JAX
    scan computes them: from the second step on (for ``0 < t < 1``) the state
    is re-noised from ``t`` to ``t_hat = t - noise * dt``; step 0 has
    ``t_hat = t``. The step then runs from ``t_hat`` to ``t_next = t + dt``."""
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    f = np.dtype(str(dtype).removeprefix("torch."))
    steps = []
    for idx in range(num_steps):
        t, dt = f.type(timesteps[idx]), f.type(dts[idx])
        churn = idx > 0 and 0.0 < t < 1.0
        steps.append((t, t - f.type(noise) * dt if churn else t, t + dt, dt))
    return timesteps, steps


def heun(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 100,
    max_t: float = 0.99,
    min_t: float = 0.001,
    noise: float = 0.5,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Karras-style second-order sampler with noise churn (denoiser.py:351-461):
    re-noise to ``t_hat``, a probability-flow step to ``t_next``, then the
    step again with the drift averaged against the one at its endpoint; two
    model evaluations a step."""
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _heun_loop(sdes, model_fn, pos, rot, generator, num_steps, max_t, min_t, noise, dtype)


def _heun_loop(sdes, model_fn, pos, rot, draws: StepNoise, num_steps, max_t, min_t, noise, dtype):
    _, steps = _heun_grid(num_steps, max_t, min_t, noise, dtype)
    batch = pos.shape[0]
    ode_pos = EulerMaruyamaPredictor(sdes.pos, 0.0, 1.0)
    ode_rot = EulerMaruyamaPredictor(sdes.node_orientations, 0.0, 1.0)
    em_pos = EulerMaruyamaPredictor(sdes.pos, 1.0, 1.0)
    em_rot = EulerMaruyamaPredictor(sdes.node_orientations, 1.0, 1.0)

    def full(value):
        return torch.full((batch,), float(value), dtype=dtype, device=pos.device)

    for idx, (t_val, t_hat, t_next, _) in enumerate(steps):
        dt_fwd, dt_step = float(t_hat - t_val), float(t_next - t_hat)
        t, th, tn = full(t_val), full(t_hat), full(t_next)

        n_pos, n_rot = _noise_at(draws, idx)
        pos_hat = em_pos.forward_sde_step(n_pos, pos, t, dt_fwd)[0]
        rot_hat = em_rot.forward_sde_step(n_rot, rot, t, dt_fwd)[0]

        pos_score, rot_score = get_score(sdes, model_fn, pos_hat, rot_hat, th)
        drift_pos, _ = ode_pos.reverse_drift_and_diffusion(pos_hat, th, pos_score)
        drift_rot, _ = ode_rot.reverse_drift_and_diffusion(rot_hat, th, rot_score)
        pos = ode_pos.mean_update(pos_hat, dt_step, drift_pos)
        rot = ode_rot.mean_update(rot_hat, dt_step, drift_rot)

        if t_next > 0.0:  # second-order correction, skipped at t_next == 0
            pos_score_n, rot_score_n = get_score(sdes, model_fn, pos, rot, tn)
            drift_pos_n, _ = ode_pos.reverse_drift_and_diffusion(pos, tn, pos_score_n)
            drift_rot_n, _ = ode_rot.reverse_drift_and_diffusion(rot, tn, rot_score_n)
            pos = ode_pos.mean_update(pos_hat, dt_step, (drift_pos + drift_pos_n) / 2)
            rot = ode_rot.mean_update(rot_hat, dt_step, (drift_rot + drift_rot_n) / 2)
    return pos, rot


class _DPMStep(NamedTuple):
    """DPM-Solver-2's position coefficients for one step from ``t`` to
    ``t_next`` through the midpoint ``t_lambda`` in lambda space. ``t_lambda``
    [B] and ``dt_mid`` (0-d) stay on the device: no host sync."""

    alpha_t: torch.Tensor
    sigma_t: torch.Tensor
    alpha_next: torch.Tensor
    sigma_next: torch.Tensor
    alpha_mid: torch.Tensor
    sigma_mid: torch.Tensor
    h_t: torch.Tensor
    t_lambda: torch.Tensor
    dt_mid: torch.Tensor

    @classmethod
    def at(cls, pos_sde: CosineVPSDE, pos, t, t_next) -> "_DPMStep":
        alpha_t, sigma_t = pos_sde.mean_coeff_and_std(pos, t)
        lambda_t = torch.log(alpha_t / sigma_t)
        alpha_next, sigma_next = pos_sde.mean_coeff_and_std(pos, t_next)
        lambda_t_next = torch.log(alpha_next / sigma_next)
        lambda_mid = (lambda_t + lambda_t_next) / 2.0
        t_lambda = _t_from_lambda(pos_sde, lambda_mid).reshape(-1)[0].expand(t.shape[0])
        alpha_mid, sigma_mid = pos_sde.mean_coeff_and_std(pos, t_lambda)
        return cls(alpha_t, sigma_t, alpha_next, sigma_next, alpha_mid, sigma_mid,
                   lambda_t_next - lambda_t, t_lambda, (t_lambda - t)[0])

    def midpoint(self, pos, score):
        """Half step in lambda space for positions."""
        return (self.alpha_mid / self.alpha_t * pos
                + self.sigma_mid * self.sigma_t * torch.expm1(self.h_t / 2.0) * score)

    def update(self, pos, score_mid):
        """The full step with the score at the midpoint."""
        return (self.alpha_next / self.alpha_t * pos
                + self.sigma_next * self.sigma_mid * torch.expm1(self.h_t) * score_mid)


def dpm_solver(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 50,
    max_t: float = 0.99,
    min_t: float = 0.001,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """DPM-Solver-2 for positions; first-order ODE plus a second-order score
    correction for rotations (denoiser.py:634-764)."""
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _dpm_solver_loop(sdes, model_fn, pos, rot, num_steps, max_t, min_t, dtype)


def _dpm_solver_loop(sdes, model_fn, pos, rot, num_steps, max_t, min_t, dtype):
    if not max_t < 1.0:
        raise ValueError(f"max_t must be < 1, got {max_t}")
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    batch = pos.shape[0]
    ode_rot = EulerMaruyamaPredictor(sdes.node_orientations, 0.0, 1.0)

    for idx in range(num_steps):
        t = torch.full((batch,), timesteps[idx], dtype=dtype, device=pos.device)
        step = _DPMStep.at(sdes.pos, pos, t, t + dts[idx])
        pos_score, rot_score = get_score(sdes, model_fn, pos, rot, t)
        pos_u = step.midpoint(pos, pos_score)

        # Rotations: first-order ODE step from t to t_lambda.
        drift_rot, _ = ode_rot.reverse_drift_and_diffusion(rot, t, rot_score)
        rot_u = ode_rot.mean_update(rot, step.dt_mid, drift_rot)

        # Correction step at the midpoint.
        pos_score_u, rot_score_u = get_score(sdes, model_fn, pos_u, rot_u, step.t_lambda)
        pos_next = step.update(pos, pos_score_u)

        # Second-order score correction for rotations.
        rot_score_corr = rot_score_u + 0.5 * (rot_score_u - rot_score) / step.dt_mid * dts[idx]
        drift_rot_c, _ = ode_rot.reverse_drift_and_diffusion(rot_u, step.t_lambda, rot_score_corr)
        rot = ode_rot.mean_update(rot, dts[idx], drift_rot_c)
        pos = pos_next
    return pos, rot


def dpm_solver_pp2m(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 30,
    max_t: float = 0.99,
    min_t: float = 0.001,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multistep DPM-Solver++(2M): second order at one model evaluation per
    step (Lu et al. 2022, arXiv:2211.01095, Algorithm 2). With
    ``h_i = lambda_{i+1} - lambda_i`` and ``r = h_{i-1} / h_i``:

        x0_i    = (x + sigma_i^2 * score) / alpha_i
        D_i     = (1 + 1/(2r)) x0_i - 1/(2r) x0_{i-1}
        x_{i+1} = (sigma_{i+1}/sigma_i) x - alpha_{i+1} (e^{-h_i} - 1) D_i

    Rotations take a first-order probability-flow ODE step on the manifold.
    The first position step is first order (DDIM).
    """
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _dpm_solver_pp2m_loop(sdes, model_fn, pos, rot, num_steps, max_t, min_t, dtype)


def _dpm_solver_pp2m_loop(sdes, model_fn, pos, rot, num_steps, max_t, min_t, dtype):
    if not max_t < 1.0:
        raise ValueError(f"max_t must be < 1, got {max_t}")
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    batch = pos.shape[0]
    ode_rot = EulerMaruyamaPredictor(sdes.node_orientations, 0.0, 1.0)
    pos_sde = sdes.pos
    x0_prev = h_prev = None

    for idx in range(num_steps):
        t = torch.full((batch,), timesteps[idx], dtype=dtype, device=pos.device)
        t_next = t + dts[idx]

        pos_score, rot_score = get_score(sdes, model_fn, pos, rot, t)

        alpha_t, sigma_t = pos_sde.mean_coeff_and_std(pos, t)
        alpha_next, sigma_next = pos_sde.mean_coeff_and_std(pos, t_next)
        h_t = torch.log(alpha_next / sigma_next) - torch.log(alpha_t / sigma_t)
        h_scalar = h_t.reshape(-1)[0]

        x0 = (pos + sigma_t**2 * pos_score) / alpha_t
        if idx == 0:
            D = x0
        else:
            r = h_prev / torch.where(h_scalar == 0, torch.ones_like(h_scalar), h_scalar)
            c = 1.0 / (2.0 * r)
            D = (1.0 + c) * x0 - c * x0_prev
        pos_next = sigma_next / sigma_t * pos - alpha_next * torch.expm1(-h_t) * D

        # Rotations: first-order geometric ODE step.
        drift_rot, _ = ode_rot.reverse_drift_and_diffusion(rot, t, rot_score)
        rot = ode_rot.mean_update(rot, dts[idx], drift_rot)
        pos, x0_prev, h_prev = pos_next, x0, h_scalar
    return pos, rot


def _prefix_products(E: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products ``P[k] = E[0] @ E[1] @ ... @ E[k]`` along
    axis 0 of ``E [T, ..., 3, 3]``, by log-depth doubling (Hillis-Steele):
    ``ceil(log2 T)`` batched 3x3 products, each over the whole trajectory,
    not ``T`` sequential ones. The JAX package's ``lax.associative_scan``
    computes the same prefixes (in another bracketing)."""
    P, shift = E, 1
    while shift < P.shape[0]:
        P = torch.cat([P[:shift], P[:-shift] @ P[shift:]])
        shift *= 2
    return P


def parallel_picard_em(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 30,
    num_sweeps: int | None = None,
    max_t: float = 0.99,
    min_t: float = 0.001,
    noise_weight: float = 1.0,
    marginal_concentration_factor: float = 1.0,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel-in-time Euler–Maruyama sampling by Picard iteration
    (``se3diff_tpu/diffusion/denoise.py:640-763``; Shih et al. 2023,
    arXiv:2305.16317, and the SO(3) variant arXiv:2507.10347).

    Each sweep evaluates the model at every step of the current trajectory
    at once (one call on a ``[num_steps * batch]`` batch) and rebuilds the
    trajectory from the prior by prefix aggregation: cumulative sums of the
    position increments and prefix products of the rotation increments
    (:func:`_prefix_products`). The noise is fixed: the prior, then each
    step's position and rotation normals, drawn from ``generator`` in the
    order :func:`euler_maruyama` draws them, so sweep ``m`` reproduces the
    sequential trajectory up to step ``m`` and ``num_sweeps == num_steps``
    equals :func:`euler_maruyama` on the same generator; fewer sweeps trade
    accuracy for fewer (larger) model calls. Not exported from
    ``se3diff_torch.diffusion``, as in the JAX package."""
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _parallel_picard_em_loop(
        sdes, model_fn, pos, rot, generator, num_steps, num_sweeps, max_t, min_t, noise_weight,
        marginal_concentration_factor, dtype,
    )


def _parallel_picard_em_loop(
    sdes, model_fn, pos0, rot0, draws: StepNoise, num_steps, num_sweeps, max_t, min_t,
    noise_weight, marginal_concentration_factor, dtype,
):
    num_sweeps = num_steps if num_sweeps is None else num_sweeps
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    T, (B, L) = num_steps, pos0.shape[:2]
    dev = pos0.device
    em_pos = EulerMaruyamaPredictor(sdes.pos, noise_weight, marginal_concentration_factor)
    em_rot = EulerMaruyamaPredictor(
        sdes.node_orientations, noise_weight, marginal_concentration_factor
    )
    if isinstance(draws, tuple):
        z_pos, z_rot = (z.to(device=dev, dtype=dtype) for z in draws)
    else:  # each step's position, then rotation, normals: euler_maruyama's order
        zs = [standard_normal(draws, pos0) for _ in range(2 * T)]
        z_pos, z_rot = torch.stack(zs[0::2]), torch.stack(zs[1::2])
    dts_t = torch.tensor(dts, dtype=dtype, device=dev).reshape(T, 1, 1, 1)
    sqdt = dts_t.abs().sqrt()
    dW_pos, dW_rot = noise_weight * sqdt * z_pos, noise_weight * sqdt * z_rot
    t_all = torch.tensor(timesteps[:T], dtype=dtype, device=dev)[:, None].expand(T, B)
    t_flat = t_all.reshape(T * B)
    tol = sdes.node_orientations.tol

    # The states before each step, [T, B, L, ...]: all the prior at first.
    pos_traj = pos0[None].expand(T, B, L, 3)
    rot_traj = rot0[None].expand(T, B, L, 3, 3)
    pos, rot = pos0, rot0
    for _ in range(num_sweeps):
        pos_score, rot_score = get_score(
            sdes, model_fn, pos_traj.reshape(T * B, L, 3), rot_traj.reshape(T * B, L, 3, 3), t_flat
        )
        drift_pos, diff_pos = em_pos.reverse_drift_and_diffusion(
            pos_traj, t_all, pos_score.reshape(T, B, L, 3))
        drift_rot, diff_rot = em_rot.reverse_drift_and_diffusion(
            rot_traj, t_all, rot_score.reshape(T, B, L, 3))
        cum_pos = torch.cumsum(drift_pos * dts_t + bcast_right(diff_pos, dW_pos) * dW_pos, dim=0)
        E = (so3_ops.rotvec_to_rotmat(drift_rot * dts_t, tol=tol)
             @ so3_ops.rotvec_to_rotmat(bcast_right(diff_rot, dW_rot) * dW_rot, tol=tol))
        rot_P = rot0 @ _prefix_products(E)                  # [T, B, L, 3, 3]
        pos_traj = torch.cat([pos0[None], pos0 + cum_pos[:-1]])
        rot_traj = torch.cat([rot0[None], rot_P[:-1]])
        pos, rot = pos0 + cum_pos[-1], rot_P[-1]
    return pos, rot


_LOOPS = {
    dpm_solver: _dpm_solver_loop,
    dpm_solver_pp2m: _dpm_solver_pp2m_loop,
    euler_maruyama: _euler_maruyama_loop,
    heun: _heun_loop,
}


def solve_from(
    denoiser: partial, sdes: SDEs, model_fn: ModelFn, pos: torch.Tensor, rot: torch.Tensor,
    draws: StepNoise | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``denoiser`` (a partial of a sampler, as bundles hold them) from the
    state ``(pos, rot)`` in place of its prior draw; the stochastic samplers
    (``euler_maruyama``, ``heun``) take their per-step normals from
    ``draws``. Data-parallel sampling draws the whole batch's prior and
    noise and solves its own rows with this."""
    loop = _LOOPS.get(denoiser.func)
    if loop is None:
        raise ValueError(f"no solver loop for {denoiser.func.__name__}")
    kw = {
        k: p.default for k, p in inspect.signature(denoiser.func).parameters.items()
        if p.default is not inspect.Parameter.empty
    }
    kw.update(denoiser.keywords)
    if "draws" in inspect.signature(loop).parameters:
        if draws is None:
            raise ValueError(f"{denoiser.func.__name__} draws noise at every step: pass draws")
        kw["draws"] = draws
    return loop(sdes, model_fn, pos, rot, **kw)


def _recorded_path(pos_path, rot_path, timesteps, us, dWs, like) -> DenoisedSDEPath:
    return DenoisedSDEPath(
        pos_path=torch.stack(pos_path),
        rot_path=torch.stack(rot_path),
        timesteps=torch.tensor(timesteps, dtype=like.dtype, device=like.device),
        us={"pos": torch.stack(us[0]), "node_orientations": torch.stack(us[1])},
        dWs={"pos": torch.stack(dWs[0]), "node_orientations": torch.stack(dWs[1])},
    )


def euler_maruyama_finetune(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    finetune_model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 200,
    max_t: float = 0.99,
    min_t: float = 0.001,
    dtype=torch.float32,
) -> DenoisedSDEPath:
    """EM sampling with the finetune control in the drift, recording the
    path (denoiser.py:267-348): per step the control ``u_t`` (the raw
    finetune-model output) and the Brownian increment ``dW_t`` of both
    channels, and the whole state trajectory."""
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _euler_maruyama_finetune_loop(
        sdes, model_fn, finetune_model_fn, pos, rot, generator, num_steps, max_t, min_t, dtype
    )


def _euler_maruyama_finetune_loop(
    sdes, model_fn, finetune_model_fn, pos, rot, draws: StepNoise, num_steps, max_t, min_t, dtype
) -> DenoisedSDEPath:
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    batch = pos.shape[0]
    em_pos = EulerMaruyamaPredictor(sdes.pos, 1.0, 1.0)
    em_rot = EulerMaruyamaPredictor(sdes.node_orientations, 1.0, 1.0)
    pos_path, rot_path, us, dWs = [pos], [rot], ([], []), ([], [])
    for idx in range(num_steps):
        t = torch.full((batch,), timesteps[idx], dtype=dtype, device=pos.device)
        pos_score, rot_score = get_score(sdes, model_fn, pos, rot, t)
        u_pos, u_rot = finetune_model_fn(pos, rot, t)
        n_pos, n_rot = _noise_at(draws, idx)
        pos, _, dW_pos = em_pos.update_given_score(n_pos, pos, t, dts[idx], pos_score, u_pos)
        rot, _, dW_rot = em_rot.update_given_score(n_rot, rot, t, dts[idx], rot_score, u_rot)
        pos_path.append(pos)
        rot_path.append(rot)
        us[0].append(u_pos)
        us[1].append(u_rot)
        dWs[0].append(dW_pos)
        dWs[1].append(dW_rot)
    return _recorded_path(pos_path, rot_path, timesteps, us, dWs, pos)


def heun_finetune(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    finetune_model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 100,
    max_t: float = 0.99,
    min_t: float = 0.001,
    noise: float = 0.5,
    dtype=torch.float32,
) -> DenoisedSDEPath:
    """Heun sampling with the finetune control and path recording
    (denoiser.py:464-620): churn to ``t_hat``, a probability-flow step to
    ``t_next`` with the drift averaged against the one at the endpoint; three
    base and three control evaluations a step. The Brownian increments are
    recovered with :meth:`EulerMaruyamaPredictor.traceback_brownian_motion`
    against the EM reverse drift at the pre-churn state ``(x, t)``, as the
    reference does."""
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _heun_finetune_loop(
        sdes, model_fn, finetune_model_fn, pos, rot, generator, num_steps, max_t, min_t, noise,
        dtype,
    )


def _heun_finetune_loop(
    sdes, model_fn, finetune_model_fn, pos, rot, draws: StepNoise, num_steps, max_t, min_t,
    noise, dtype,
) -> DenoisedSDEPath:
    timesteps, steps = _heun_grid(num_steps, max_t, min_t, noise, dtype)
    batch = pos.shape[0]
    ode_pos = EulerMaruyamaPredictor(sdes.pos, 0.0, 1.0)
    ode_rot = EulerMaruyamaPredictor(sdes.node_orientations, 0.0, 1.0)
    em_pos = EulerMaruyamaPredictor(sdes.pos, 1.0, 1.0)
    em_rot = EulerMaruyamaPredictor(sdes.node_orientations, 1.0, 1.0)
    pos_path, rot_path, us, dWs = [pos], [rot], ([], []), ([], [])

    def full(value):
        return torch.full((batch,), float(value), dtype=dtype, device=pos.device)

    for idx, (t_val, t_hat, t_next, dt) in enumerate(steps):
        dt_fwd, dt_step = float(t_hat - t_val), float(t_next - t_hat)
        t, th, tn = full(t_val), full(t_hat), full(t_next)

        n_pos, n_rot = _noise_at(draws, idx)
        pos_hat = em_pos.forward_sde_step(n_pos, pos, t, dt_fwd)[0]
        rot_hat = em_rot.forward_sde_step(n_rot, rot, t, dt_fwd)[0]

        pos_score_hat, rot_score_hat = get_score(sdes, model_fn, pos_hat, rot_hat, th)
        u_pos_hat, u_rot_hat = finetune_model_fn(pos_hat, rot_hat, th)
        # Scores and controls at the pre-churn state, for the dW traceback.
        pos_score_pre, rot_score_pre = get_score(sdes, model_fn, pos, rot, t)
        u_pos_pre, u_rot_pre = finetune_model_fn(pos, rot, t)

        drift_pos, _ = ode_pos.reverse_drift_and_diffusion(pos_hat, th, pos_score_hat, u_pos_hat)
        drift_rot, _ = ode_rot.reverse_drift_and_diffusion(rot_hat, th, rot_score_hat, u_rot_hat)
        pos_1 = ode_pos.mean_update(pos_hat, dt_step, drift_pos)
        rot_1 = ode_rot.mean_update(rot_hat, dt_step, drift_rot)

        pos_score_n, rot_score_n = get_score(sdes, model_fn, pos_1, rot_1, tn)
        u_pos_n, u_rot_n = finetune_model_fn(pos_1, rot_1, tn)
        if t_next > 0.0:  # second-order correction, skipped at t_next == 0
            drift_pos_n, _ = ode_pos.reverse_drift_and_diffusion(pos_1, tn, pos_score_n, u_pos_n)
            drift_rot_n, _ = ode_rot.reverse_drift_and_diffusion(rot_1, tn, rot_score_n, u_rot_n)
            pos_new = ode_pos.mean_update(pos_hat, dt_step, (drift_pos + drift_pos_n) / 2)
            rot_new = ode_rot.mean_update(rot_hat, dt_step, (drift_rot + drift_rot_n) / 2)
        else:
            pos_new, rot_new = pos_1, rot_1

        dW_pos = em_pos.traceback_brownian_motion(
            pos_new, pos, t, float(dt), pos_score_pre, u_pos_pre)
        dW_rot = em_rot.traceback_brownian_motion(
            rot_new, rot, t, float(dt), rot_score_pre, u_rot_pre)
        pos, rot = pos_new, rot_new
        pos_path.append(pos)
        rot_path.append(rot)
        us[0].append(u_pos_pre)
        us[1].append(u_rot_pre)
        dWs[0].append(dW_pos)
        dWs[1].append(dW_rot)
    return _recorded_path(pos_path, rot_path, timesteps, us, dWs, pos)


def sde_dpm_solver_finetune(
    generator: torch.Generator,
    sdes: SDEs,
    model_fn: ModelFn,
    finetune_model_fn: ModelFn,
    batch: int,
    length: int,
    num_steps: int = 30,
    max_t: float = 0.99,
    min_t: float = 0.001,
    dtype=torch.float32,
) -> DenoisedSDEPath:
    """DPM-Solver-2 with the finetune control, recording the path; two base
    and two control evaluations a step, and no draws after the prior. (The
    reference ships an empty stub, denoiser.py:767-777; this follows the JAX
    package's implementation.)

    The control enters the positions through the controlled score
    ``score - u / g``, which leaves the lambda-space step unchanged, and the
    rotations through ``reverse_drift_and_diffusion(finetune_score=u)``.
    The Brownian increments are those the recorded transition implies under
    the controlled Euler–Maruyama step at the pre-step state, recovered with
    :meth:`EulerMaruyamaPredictor.traceback_brownian_motion`: what the PPFT
    replay needs of ``(x_path, u, dW)``. ``us`` are the pre-step controls."""
    pos, rot = _prior(generator, sdes, batch, length, dtype)
    return _sde_dpm_solver_finetune_loop(
        sdes, model_fn, finetune_model_fn, pos, rot, num_steps, max_t, min_t, dtype
    )


def _sde_dpm_solver_finetune_loop(
    sdes, model_fn, finetune_model_fn, pos, rot, num_steps, max_t, min_t, dtype
) -> DenoisedSDEPath:
    if not max_t < 1.0:
        raise ValueError(f"max_t must be < 1, got {max_t}")
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    batch = pos.shape[0]
    ode_rot = EulerMaruyamaPredictor(sdes.node_orientations, 0.0, 1.0)
    em_pos = EulerMaruyamaPredictor(sdes.pos, 1.0, 1.0)
    em_rot = EulerMaruyamaPredictor(sdes.node_orientations, 1.0, 1.0)
    pos_path, rot_path, us, dWs = [pos], [rot], ([], []), ([], [])

    def controlled(pos, rot, t):
        """Scores and controls at ``(x, t)``, and the controlled position
        score ``score - u / g``."""
        pos_score, rot_score = get_score(sdes, model_fn, pos, rot, t)
        u_pos, u_rot = finetune_model_fn(pos, rot, t)
        _, g = sdes.pos.sde(x=pos, t=t)
        return pos_score, rot_score, u_pos, u_rot, pos_score - u_pos / g

    for idx in range(num_steps):
        t = torch.full((batch,), timesteps[idx], dtype=dtype, device=pos.device)
        step = _DPMStep.at(sdes.pos, pos, t, t + dts[idx])
        pos_score, rot_score, u_pos, u_rot, pos_eff = controlled(pos, rot, t)
        pos_u = step.midpoint(pos, pos_eff)

        # Rotations: first-order controlled ODE step from t to t_lambda.
        drift_rot, _ = ode_rot.reverse_drift_and_diffusion(rot, t, rot_score, u_rot)
        rot_u = ode_rot.mean_update(rot, step.dt_mid, drift_rot)

        # Correction at the midpoint, the control evaluated there.
        _, rot_score_u, _, u_rot_u, pos_eff_u = controlled(pos_u, rot_u, step.t_lambda)
        pos_next = step.update(pos, pos_eff_u)
        rot_score_corr = rot_score_u + 0.5 * (rot_score_u - rot_score) / step.dt_mid * dts[idx]
        drift_rot_c, _ = ode_rot.reverse_drift_and_diffusion(
            rot_u, step.t_lambda, rot_score_corr, u_rot_u)
        rot_next = ode_rot.mean_update(rot, dts[idx], drift_rot_c)

        dW_pos = em_pos.traceback_brownian_motion(pos_next, pos, t, dts[idx], pos_score, u_pos)
        dW_rot = em_rot.traceback_brownian_motion(rot_next, rot, t, dts[idx], rot_score, u_rot)
        pos, rot = pos_next, rot_next
        pos_path.append(pos)
        rot_path.append(rot)
        us[0].append(u_pos)
        us[1].append(u_rot)
        dWs[0].append(dW_pos)
        dWs[1].append(dW_rot)
    return _recorded_path(pos_path, rot_path, timesteps, us, dWs, pos)
