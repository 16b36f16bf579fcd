"""DiG score network and its weight loaders."""

from se3diff_torch.models.convert import load_checkpoint, state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel, DistributionalGraphormer

__all__ = [
    "DiGConditionalScoreModel",
    "DistributionalGraphormer",
    "load_checkpoint",
    "state_dict_from_jax",
]
