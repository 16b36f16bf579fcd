"""IGSO(3)-mixture toy framework (reference se3diff/ prototype)."""

from se3diff_torch.toy.finetune import assign_igso3, compute_finetune_loss, finetune_toy, reverse_finetune_diffusion
from se3diff_torch.toy.models import DiGMixSO3SDE, ScoreNet
from se3diff_torch.toy.train import compute_train_loss, igso3_mixture_marginal_pdf, reverse_diffusion, train_toy

__all__ = [
    "DiGMixSO3SDE",
    "ScoreNet",
    "assign_igso3",
    "compute_finetune_loss",
    "compute_train_loss",
    "finetune_toy",
    "igso3_mixture_marginal_pdf",
    "reverse_diffusion",
    "reverse_finetune_diffusion",
    "train_toy",
]
