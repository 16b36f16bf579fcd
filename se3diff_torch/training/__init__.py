"""DSM training: ensemble data, the loss and its step, the loop."""

from se3diff_torch.training.data import EnsembleDataset, MultiEnsembleDataset
from se3diff_torch.training.dsm import (
    DSMNoise,
    draw_noise,
    dsm_denominator,
    dsm_loss,
    mesh_train_step,
    train_step,
)
from se3diff_torch.training.loop import TrainConfig, make_optimizer, make_schedule, train_dsm

__all__ = [
    "EnsembleDataset",
    "MultiEnsembleDataset",
    "DSMNoise",
    "draw_noise",
    "dsm_denominator",
    "dsm_loss",
    "mesh_train_step",
    "train_step",
    "TrainConfig",
    "make_optimizer",
    "make_schedule",
    "train_dsm",
]
