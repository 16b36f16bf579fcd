"""Reverse-diffusion samplers (DPM solvers) and predictors."""

from se3diff_torch.diffusion.denoise import (
    SDEs,
    dpm_solver,
    dpm_solver_pp2m,
    get_score,
)
from se3diff_torch.diffusion.predictors import EulerMaruyamaPredictor

__all__ = [
    "SDEs",
    "EulerMaruyamaPredictor",
    "dpm_solver",
    "dpm_solver_pp2m",
    "get_score",
]
