"""DiG score network and its weight loaders."""

from se3diff_torch.models.convert import load_checkpoint, state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel, DistributionalGraphormer, count_params

__all__ = [
    "DiGConditionalScoreModel",
    "DistributionalGraphormer",
    "count_params",
    "load_checkpoint",
    "state_dict_from_jax",
]
