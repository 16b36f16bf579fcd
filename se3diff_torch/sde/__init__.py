"""Corruption processes: Euclidean VP SDE + SO(3) IGSO(3) SDEs."""

from se3diff_torch.sde.base import SDE, bcast_right
from se3diff_torch.sde.so3_sde import DiGSO3SDE, SO3SDE
from se3diff_torch.sde.vpsde import BaseVPSDE, CosineVPSDE

__all__ = ["SDE", "bcast_right", "SO3SDE", "DiGSO3SDE", "BaseVPSDE", "CosineVPSDE"]
