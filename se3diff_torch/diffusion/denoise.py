"""Reverse-diffusion samplers: DPM-Solver-2 and DPM-Solver++(2M), and the
PPFT path recorders (Euler–Maruyama and Heun with a finetune control).

Counterpart of ``se3diff_tpu/diffusion/denoise.py`` (reference
`bioemu/src/bioemu/denoiser.py:206-777`). Each solver draws the prior and
then runs a Python loop over the time grid; every step stays on the device
of the prior's generator, with no host synchronisation inside the loop.
The recorders draw their per-step standard normals from the same generator
(positions, then rotations, each step); their private loops also take the
draws as tensors, so tests can feed both packages the same noise.

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

from se3diff_torch.diffusion.predictors import EulerMaruyamaPredictor
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
    pos_sde = sdes.pos

    for idx in range(num_steps):
        t = torch.full((batch,), timesteps[idx], dtype=dtype, device=pos.device)
        t_next = t + dts[idx]

        pos_score, rot_score = get_score(sdes, model_fn, pos, rot, t)

        alpha_t, sigma_t = pos_sde.mean_coeff_and_std(pos, t)
        lambda_t = torch.log(alpha_t / sigma_t)
        alpha_t_next, sigma_t_next = pos_sde.mean_coeff_and_std(pos, t_next)
        lambda_t_next = torch.log(alpha_t_next / sigma_t_next)
        h_t = lambda_t_next - lambda_t

        lambda_mid = (lambda_t + lambda_t_next) / 2.0
        t_lambda = _t_from_lambda(pos_sde, lambda_mid).reshape(-1)[0].expand(batch)
        alpha_t_lambda, sigma_t_lambda = pos_sde.mean_coeff_and_std(pos, t_lambda)

        # Half step in lambda space for positions.
        pos_u = (
            alpha_t_lambda / alpha_t * pos
            + sigma_t_lambda * sigma_t * torch.expm1(h_t / 2.0) * pos_score
        )

        # Rotations: first-order ODE step from t to t_lambda.
        dt_mid = (t_lambda - t)[0]
        drift_rot, _ = ode_rot.reverse_drift_and_diffusion(rot, t, rot_score)
        rot_u = ode_rot.mean_update(rot, dt_mid, drift_rot)

        # Correction step at the midpoint.
        pos_score_u, rot_score_u = get_score(sdes, model_fn, pos_u, rot_u, t_lambda)

        pos_next = (
            alpha_t_next / alpha_t * pos
            + sigma_t_next * sigma_t_lambda * torch.expm1(h_t) * pos_score_u
        )

        # Second-order score correction for rotations.
        rot_score_corr = rot_score_u + 0.5 * (rot_score_u - rot_score) / dt_mid * dts[idx]
        drift_rot_c, _ = ode_rot.reverse_drift_and_diffusion(rot_u, t_lambda, rot_score_corr)
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


_LOOPS = {dpm_solver: _dpm_solver_loop, dpm_solver_pp2m: _dpm_solver_pp2m_loop}


def solve_from(
    denoiser: partial, sdes: SDEs, model_fn: ModelFn, pos: torch.Tensor, rot: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``denoiser`` (a partial of :func:`dpm_solver` or
    :func:`dpm_solver_pp2m`, as bundles hold them) from the state
    ``(pos, rot)`` in place of its prior draw. Data-parallel sampling draws
    the whole batch's prior and solves its own rows with this."""
    if denoiser.func not in _LOOPS:
        raise ValueError(f"no solver loop for {denoiser.func.__name__}")
    kw = {
        k: p.default for k, p in inspect.signature(denoiser.func).parameters.items()
        if p.default is not inspect.Parameter.empty
    }
    kw.update(denoiser.keywords)
    return _LOOPS[denoiser.func](
        sdes, model_fn, pos, rot, kw["num_steps"], kw["max_t"], kw["min_t"], kw["dtype"]
    )


# Noise of a recorder's loop: a generator (draws positions then rotations at
# each step) or the draws themselves, ``(z_pos [T, B, L, 3], z_rot [T, B, L, 3])``.
StepNoise = torch.Generator | tuple[torch.Tensor, torch.Tensor]


def _noise_at(noise: StepNoise, idx: int):
    if isinstance(noise, torch.Generator):
        return noise, noise
    return noise[0][idx], noise[1][idx]


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
    sdes, model_fn, finetune_model_fn, pos, rot, noise: StepNoise, num_steps, max_t, min_t, dtype
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
        n_pos, n_rot = _noise_at(noise, idx)
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
    sdes, model_fn, finetune_model_fn, pos, rot, noise: StepNoise, num_steps, max_t, min_t,
    churn_noise, dtype,
) -> DenoisedSDEPath:
    timesteps, dts = _timegrid(num_steps, max_t, min_t, dtype)
    batch = pos.shape[0]
    ode_pos = EulerMaruyamaPredictor(sdes.pos, 0.0, 1.0)
    ode_rot = EulerMaruyamaPredictor(sdes.node_orientations, 0.0, 1.0)
    em_pos = EulerMaruyamaPredictor(sdes.pos, 1.0, 1.0)
    em_rot = EulerMaruyamaPredictor(sdes.node_orientations, 1.0, 1.0)
    # Host scalars in the grid's precision, as the JAX scan computes them.
    f = np.dtype(str(dtype).removeprefix("torch."))
    pos_path, rot_path, us, dWs = [pos], [rot], ([], []), ([], [])

    def full(value):
        return torch.full((batch,), float(value), dtype=dtype, device=pos.device)

    for idx in range(num_steps):
        t_val, dt = f.type(timesteps[idx]), f.type(dts[idx])
        t_next = t_val + dt
        churn = idx > 0 and 0.0 < t_val < 1.0
        t_hat = t_val - f.type(churn_noise) * dt if churn else t_val
        dt_fwd, dt_step = float(t_hat - t_val), float(t_next - t_hat)
        t, th, tn = full(t_val), full(t_hat), full(t_next)

        n_pos, n_rot = _noise_at(noise, idx)
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
