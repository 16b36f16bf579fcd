"""Toy SO(3) score model and IGSO(3)-mixture SDE (the se3diff prototype).

Counterpart of ``se3diff_tpu/toy/models.py`` (reference `se3diff/models.py`):
a small MLP score network on SO(3) and a mixture-of-IGSO(3) data
distribution, whose known answer checks the diffusion and fine-tuning stack
end to end. :func:`state_dict_from_flax` carries the JAX package's flax
``ScoreNet`` parameters across.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from se3diff_torch.models.dig import SinusoidalPositionEmbedder
from se3diff_torch.ops import so3 as so3_ops
from se3diff_torch.sde.so3_sde import DiGSO3SDE

# std of flax's lecun_normal: a normal truncated at two std devs, rescaled to
# unit variance (jax.nn.initializers.variance_scaling, "truncated_normal").
_TRUNCATED_NORMAL_STD = 0.87962566103423978
_LINEARS = ("rot_embed", "fc1", "fc2", "fc3")


class ScoreNet(nn.Module):
    """MLP score net: rotvec embed + sinusoidal time embed -> 3-vector score
    (se3diff/models.py:9-61). Initialised as flax initialises the JAX
    package's (lecun-normal kernels, zero biases; LayerNorm eps 1e-6)."""

    def __init__(self, rot_embed_dim: int = 32, time_embed_dim: int = 32, hidden_dim: int = 128):
        super().__init__()
        self.rot_embed = nn.Linear(3, rot_embed_dim)
        self.rot_ln = nn.LayerNorm(rot_embed_dim, eps=1e-6)
        self.time_embed = SinusoidalPositionEmbedder(time_embed_dim)
        self.fc1 = nn.Linear(rot_embed_dim + time_embed_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, 3)
        for name in _LINEARS:
            lin = getattr(self, name)
            std = math.sqrt(1.0 / lin.in_features) / _TRUNCATED_NORMAL_STD
            nn.init.trunc_normal_(lin.weight, std=std, a=-2.0 * std, b=2.0 * std)
            nn.init.zeros_(lin.bias)

    def forward(self, rot_mat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        rot_emb = F.relu(self.rot_ln(self.rot_embed(so3_ops.rotmat_to_rotvec(rot_mat))))
        t_emb = self.time_embed(t).expand(*rot_emb.shape[:-1], -1)
        x = torch.cat([rot_emb, t_emb], dim=-1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


def state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``ScoreNet`` variables (numpy) -> :class:`ScoreNet`'s state dict:
    ``Dense`` kernels ``[in, out]`` become ``Linear`` weights ``[out, in]``,
    LayerNorm ``scale``/``bias`` become ``weight``/``bias``."""
    params = variables["params"]
    sd = {}
    for name in _LINEARS:
        sd[f"{name}.weight"] = np.asarray(params[name]["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"])
    sd["rot_ln.weight"] = np.asarray(params["rot_ln"]["scale"])
    sd["rot_ln.bias"] = np.asarray(params["rot_ln"]["bias"])
    sd["time_embed.dummy"] = np.zeros((0,), np.float32)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


class DiGMixSO3SDE(DiGSO3SDE):
    """DiGSO3SDE whose data distribution is a mixture of IGSO(3) components
    (se3diff/models.py:64-89)."""

    def sample_multiple_igso3(
        self,
        generator: torch.Generator,
        mus: torch.Tensor,  # [K, 3, 3]
        sigmas: torch.Tensor,  # [K]
        weights: torch.Tensor,  # [K]
        num_samples: int,
    ) -> torch.Tensor:
        """Draw ``x0 = mu_k @ IGSO3(I, sigma_k)`` with ``k ~ Cat(weights)``:
        the components, then each rotation's axis normals and angle uniform."""
        k = torch.multinomial(weights, num_samples, replacement=True, generator=generator)
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        axes = torch.randn((num_samples, 3), **kw)
        p_uniform = torch.rand((num_samples,), **kw)
        return self.mixture_from_draws(mus, sigmas, k, axes, p_uniform)

    def mixture_from_draws(
        self,
        mus: torch.Tensor,
        sigmas: torch.Tensor,
        k: torch.Tensor,
        axes: torch.Tensor,
        p_uniform: torch.Tensor,
    ) -> torch.Tensor:
        """:meth:`sample_multiple_igso3` on given draws: component indices
        ``k [B]``, and the IGSO(3) draws of :meth:`igso3_from_draws`."""
        return mus[k] @ self.igso3_from_draws(sigmas[k], axes, p_uniform)
