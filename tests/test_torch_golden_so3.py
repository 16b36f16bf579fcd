"""SO(3) golden parity for the port: its IGSO(3) expansions and DiGSO3SDE
against the reference's torch stack.

``tests/test_data/golden_so3/reference_small.npz`` holds what the reference's
`bioemu/src/bioemu/so3_sde.py` (torch, CPU) recorded for a small table
configuration (num_sigma=32, num_omega=128, l_max=100, sigma in [0.02, 1.65]):
the marginal sigma schedule, the score scaling lambda(t), scores at probe
rotation vectors, and the raw igso3/dlog expansions at sigma=0.5. Each test
holds the port to the tolerance of ``tests/test_golden_so3.py``, in the same
precision: float64 for the expansions and the schedule, the SDE's float32
working dtype for the scaling and the scores.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from se3diff_torch.ops import igso3 as igso3_ops
from se3diff_torch.sde.so3_sde import DiGSO3SDE

DATA = Path(__file__).parent / "test_data" / "golden_so3" / "reference_small.npz"


@pytest.fixture(scope="module")
def golden():
    with np.load(DATA) as d:
        return {k: d[k] for k in d}


@pytest.fixture(scope="module")
def sde():
    return DiGSO3SDE(
        eps_t=1e-4, num_sigma=32, num_omega=128, omega_exponent=3, l_max=100,
        sigma_min=0.02, sigma_max=1.65, tol=1e-7, device="cpu",
    )


def test_expansion_matches_reference(golden):
    l_grid = torch.arange(100, dtype=torch.float64)
    omega = torch.from_numpy(golden["omega"])
    f = igso3_ops.igso3_expansion(omega, torch.full_like(omega, 0.5), l_grid)
    np.testing.assert_allclose(f.numpy(), golden["expansion"], rtol=1e-6, atol=1e-12)


def test_dlog_matches_reference(golden):
    l_grid = torch.arange(100, dtype=torch.float64)
    omega = torch.from_numpy(golden["omega"])
    dlog = igso3_ops.dlog_igso3_expansion(omega, torch.full_like(omega, 0.5), l_grid)
    np.testing.assert_allclose(dlog.numpy(), golden["dlog"], rtol=1e-6, atol=1e-8)


def test_sigma_schedule_matches(golden, sde):
    ours = sde._marginal_std(torch.from_numpy(golden["ts"]))
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), golden["sigma"], rtol=1e-12)


def test_score_scaling_matches(golden, sde):
    ours = sde.get_score_scaling(torch.from_numpy(golden["ts"].astype(np.float32)))
    np.testing.assert_allclose(ours.numpy(), golden["scaling"], rtol=2e-3)


def test_score_matches(golden, sde):
    """Series score == reference runtime score where the density is
    non-negligible (the far tail is truncation noise in both stacks)."""
    score = sde.compute_score(
        torch.from_numpy(golden["rotvecs"]),
        torch.from_numpy(golden["ts"].astype(np.float32)),
        method="series",
    )
    assert score.dtype == torch.float32
    angles = np.linalg.norm(golden["rotvecs"], axis=-1)
    f = igso3_ops.igso3_expansion(
        torch.from_numpy(angles.astype(np.float64)),
        torch.from_numpy(golden["sigma"]),
        torch.arange(101, dtype=torch.float64),
    ).numpy()
    mask = f > 1e-4
    assert mask.sum() >= 7
    np.testing.assert_allclose(score.numpy()[mask], golden["score"][mask], rtol=2e-3, atol=1e-3)
