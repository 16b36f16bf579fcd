"""Differentiable h-functions for PPFT fine-tuning targets.

Counterpart of ``se3diff_tpu/ppft/h_functions.py`` (reference
`observables/folding_stability.py`, `observables/folding_binding.py`):
smooth (sigmoid-of-dRMSD) fold/bind probabilities of the final denoised
batch. The reference structure is a constructor argument; the default is the
repository's ``assets/structures/2vwf_trimmed_SH3.pdb``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from se3diff_torch.ppft.observables import SH3_INTERFACE_RESIDUES, load_ref

K_BOLTZMANN = 0.001987203599772605  # kcal / mol / K (free_energies.py:11)

_ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets")
DEFAULT_SH3_REF = os.path.normpath(os.path.join(_ASSETS, "structures", "2vwf_trimmed_SH3.pdb"))


def compute_folded_proportion(
    coords: torch.Tensor, ref_coords: torch.Tensor, k: float = -24.0, d_0: float = 0.4,
    tol: float = 1e-7,
) -> torch.Tensor:
    """p_folded via the f_dRMSD sigmoid (folding_stability.py:52-81).

    ``coords [B, L, 3]`` nm, ``ref_coords [L, 3]`` nm -> ``[B]``.
    """

    def cdist(x):
        return torch.linalg.vector_norm(x[..., :, None, :] - x[..., None, :, :] + 1e-12, dim=-1)

    delta = cdist(coords) - cdist(ref_coords[None])
    drmsd = torch.sqrt(delta.square().mean(dim=(-1, -2)))
    p = torch.sigmoid(k * (drmsd - d_0))
    return p.clamp(tol, 1.0 - tol)


def compute_dg(p_folded: torch.Tensor, temperature: float = 298.0, tol: float = 1e-7):
    """Folding free energy (kcal/mol) from the ensemble-mean p_folded
    (folding_stability.py:84-100)."""
    p = p_folded.mean().clamp(tol, 1.0 - tol)
    return -K_BOLTZMANN * temperature * torch.log(p / (1.0 - p))


def compute_folded_proportion_from_dg(dg: torch.Tensor, temperature: float = 298.0):
    """The folded proportion of a folding free energy ``dg`` (kcal/mol), the
    inverse Boltzmann relation (folding_stability.py:103-116)."""
    return torch.sigmoid(-torch.as_tensor(dg) / (K_BOLTZMANN * temperature))


def _ref(path: str, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(load_ref(path)).to(device=like.device, dtype=like.dtype)


@dataclass(frozen=True)
class FoldingStability:
    """h(x) = p_folded(x), ``[B, 1]`` (folding_stability.py:120-194)."""

    k: float = -24.0
    d_0: float = 0.4
    tol: float = 1e-7
    ref_path: str = DEFAULT_SH3_REF

    @property
    def num_observables(self) -> int:
        return 1

    def __call__(self, pos: torch.Tensor, sequence: str) -> torch.Tensor:
        del sequence  # the reference structure is per system, not per mutant
        p = compute_folded_proportion(pos, _ref(self.ref_path, pos), self.k, self.d_0, self.tol)
        return p[:, None]


@dataclass(frozen=True)
class FoldingBinding:
    """h(x) = (p_folded, p_bound), ``[B, 2]`` (folding_binding.py:119-205):
    p_bound is the same dRMSD sigmoid on the binding-interface residues."""

    k: float = -24.0
    d_0: float = 0.4
    tol: float = 1e-7
    ref_path: str = DEFAULT_SH3_REF
    interface_residues: tuple[int, ...] = SH3_INTERFACE_RESIDUES

    @property
    def num_observables(self) -> int:
        return 2

    def __call__(self, pos: torch.Tensor, sequence: str) -> torch.Tensor:
        del sequence
        ref = _ref(self.ref_path, pos)
        idx = list(self.interface_residues)
        p_folded = compute_folded_proportion(pos, ref, self.k, self.d_0, self.tol)
        p_bound = compute_folded_proportion(pos[:, idx], ref[idx], self.k, self.d_0, self.tol)
        return torch.stack([p_folded, p_bound], dim=-1)


H_FUNCTIONS = {
    "folding_stability": FoldingStability,
    "folding_binding": FoldingBinding,
}
