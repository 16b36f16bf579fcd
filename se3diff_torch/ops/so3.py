"""Rotation algebra on SO(3) as batched PyTorch tensor functions.

Counterpart of ``se3diff_tpu/ops/so3.py`` (the reference rotation utilities,
`bioemu/src/bioemu/so3_sde.py:406-911`):

* rotvec <-> rotmat via Rodrigues' formula with Taylor branches near 0,
* log map with the outer-product branch near pi,
* quaternion conversions, geodesics and skew-matrix helpers.

All functions broadcast over leading batch dimensions and act on trailing
``[..., 3]`` (vectors) / ``[..., 3, 3]`` (matrices) axes. Every branch is a
``torch.where`` mask, so no function synchronises with the device.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "vector_to_skew_matrix",
    "skew_matrix_to_vector",
    "skew_matrix_exponential_map",
    "rotvec_to_rotmat",
    "angle_from_rotmat",
    "rotmat_to_rotvec",
    "rotquat_to_rotvec",
    "rotquat_to_rotmat",
    "apply_rotvec_to_rotmat",
    "scale_rotmat",
    "rot_transpose",
    "rot_mult",
    "rotmat_to_skew_matrix",
    "skew_matrix_to_rotmat",
    "local_log",
    "geodesic_dist",
    "rot_vf",
    "geodesic_t",
    "random_rotmat",
]


def vector_to_skew_matrix(vectors: torch.Tensor) -> torch.Tensor:
    """``[x, y, z] -> [[0, -z, y], [z, 0, -x], [-y, x, 0]]`` (so3_sde.py:679-705)."""
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def skew_matrix_to_vector(skew_matrices: torch.Tensor) -> torch.Tensor:
    """Extract the so(3) vector from a skew matrix (so3_sde.py:708-722)."""
    return torch.stack(
        [skew_matrices[..., 2, 1], skew_matrices[..., 0, 2], skew_matrices[..., 1, 0]],
        dim=-1,
    )


def _rodrigues(skew: torch.Tensor, sin_coeff: torch.Tensor, cos_coeff: torch.Tensor):
    eye = torch.eye(3, dtype=skew.dtype, device=skew.device)
    return eye + sin_coeff * skew + cos_coeff * (skew @ skew)


def skew_matrix_exponential_map(
    angles: torch.Tensor, skew_matrices: torch.Tensor, tol: float = 1e-7
) -> torch.Tensor:
    """Rodrigues' formula ``exp(K) = I + sin(t)/t K + (1-cos(t))/t^2 K^2``.

    The skew matrix already carries the angle; coefficients switch to
    second-order Taylor expansions for ``|angle| < tol`` (so3_sde.py:478-530).
    """
    angles = angles[..., None, None]
    mask_zero = angles.abs() < tol
    safe = torch.where(mask_zero, torch.ones_like(angles), angles)
    sq = angles.square()
    sin_coeff = torch.where(mask_zero, 1.0 - sq / 6.0, torch.sin(safe) / safe)
    cos_coeff = torch.where(mask_zero, 0.5 - sq / 24.0, (1.0 - torch.cos(safe)) / safe.square())
    return _rodrigues(skew_matrices, sin_coeff, cos_coeff)


def rotvec_to_rotmat(rotation_vectors: torch.Tensor, tol: float = 1e-7) -> torch.Tensor:
    """Exponential map so(3) -> SO(3): ``[..., 3] -> [..., 3, 3]``.

    The small-angle branch is a polynomial in ``|v|^2`` so the gradient is
    finite at exactly ``v = 0``.
    """
    sq = rotation_vectors.square().sum(-1)[..., None, None]
    mask_zero = sq < tol**2
    safe_sq = torch.where(mask_zero, torch.ones_like(sq), sq)
    angles = torch.sqrt(safe_sq)
    sin_coeff = torch.where(mask_zero, 1.0 - sq / 6.0, torch.sin(angles) / angles)
    cos_coeff = torch.where(mask_zero, 0.5 - sq / 24.0, (1.0 - torch.cos(angles)) / safe_sq)
    return _rodrigues(vector_to_skew_matrix(rotation_vectors), sin_coeff, cos_coeff)


def angle_from_rotmat(
    rotation_matrices: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation angle (plus its sin/cos) via atan2 (so3_sde.py:651-676)."""
    skew_vec = skew_matrix_to_vector(rotation_matrices - rotation_matrices.transpose(-2, -1))
    angles_sin = torch.linalg.vector_norm(skew_vec, dim=-1) / 2.0
    angles_cos = (torch.diagonal(rotation_matrices, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.atan2(angles_sin, angles_cos), angles_sin, angles_cos


def rotmat_to_rotvec(rotation_matrices: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3) with three numerically stable branches.

    1. ``theta ~ 0``: Taylor expansion of the ``theta / (2 sin theta)`` prefactor,
    2. generic ``theta``: ``theta/(2 sin theta) [R - R^T]^vee``,
    3. ``theta ~ pi`` (within 1e-2): ``w w^T = (I + R)/2`` with signs from the
       largest-norm row (so3_sde.py:557-648).
    """
    dtype = rotation_matrices.dtype
    angles, angles_sin, _ = angle_from_rotmat(rotation_matrices)
    vector = skew_matrix_to_vector(rotation_matrices - rotation_matrices.transpose(-2, -1))

    eps_zero = 1e-8 if dtype == torch.float64 else 1e-6
    mask_zero = (angles.abs() < eps_zero).to(dtype)
    mask_pi = ((angles - math.pi).abs() < 1e-2).to(dtype)
    mask_else = (1.0 - mask_zero) * (1.0 - mask_pi)

    numerator = mask_zero / 2.0 + angles * mask_else
    denominator = (
        (1.0 - angles.square() / 6.0) * mask_zero + 2.0 * angles_sin * mask_else + mask_pi
    )
    vector = vector * (numerator / denominator)[..., None]

    eye = torch.eye(3, dtype=dtype, device=rotation_matrices.device)
    skew_outer = (eye + rotation_matrices) / 2.0
    diag = torch.diagonal(skew_outer, dim1=-2, dim2=-1).clamp(min=1e-8)
    vector_pi = torch.sqrt(diag)

    signs_line_idx = torch.argmax(torch.linalg.vector_norm(skew_outer, dim=-1), dim=-1)
    signs_line = torch.take_along_dim(
        skew_outer, signs_line_idx[..., None, None], dim=-2
    )[..., 0, :]
    vector_pi = vector_pi * angles[..., None] * torch.sign(signs_line)
    return vector + vector_pi * mask_pi[..., None]


def _rotquat_to_axis_angle(
    rotation_quaternions: torch.Tensor, tol: float = 1e-7
) -> tuple[torch.Tensor, torch.Tensor]:
    """Angle/axis from unit quaternions in [r, i, j, k] format."""
    axes = rotation_quaternions[..., 1:]
    axes_norms = torch.linalg.vector_norm(axes, dim=-1)
    angles = 2.0 * torch.atan2(axes_norms, rotation_quaternions[..., 0])
    return angles, axes / (axes_norms[..., None] + tol)


def rotquat_to_rotvec(rotation_quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [r,i,j,k] -> rotation vector (so3_sde.py:751-764)."""
    angles, axes = _rotquat_to_axis_angle(rotation_quaternions)
    return axes * angles[..., None]


def rotquat_to_rotmat(rotation_quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [r,i,j,k] -> rotation matrix (so3_sde.py:767-779)."""
    angles, axes = _rotquat_to_axis_angle(rotation_quaternions)
    return skew_matrix_exponential_map(angles, vector_to_skew_matrix(axes * angles[..., None]))


def apply_rotvec_to_rotmat(
    rotation_matrices: torch.Tensor, rotation_vectors: torch.Tensor, tol: float = 1e-7
) -> torch.Tensor:
    """Right-compose a rotation-vector increment ``R <- R exp(v)`` (so3_sde.py:782-802)."""
    return rotation_matrices @ rotvec_to_rotmat(rotation_vectors, tol=tol)


def scale_rotmat(
    rotation_matrix: torch.Tensor, scalar: torch.Tensor | float, tol: float = 1e-7
) -> torch.Tensor:
    """Scale a rotation by shrinking its rotation vector (so3_sde.py:406-425)."""
    return rotvec_to_rotmat(rotmat_to_rotvec(rotation_matrix) * scalar, tol=tol)


def rot_transpose(mat: torch.Tensor) -> torch.Tensor:
    return mat.transpose(-1, -2)


def rot_mult(mat_1: torch.Tensor, mat_2: torch.Tensor) -> torch.Tensor:
    return mat_1 @ mat_2


def rotmat_to_skew_matrix(mat: torch.Tensor) -> torch.Tensor:
    return vector_to_skew_matrix(rotmat_to_rotvec(mat))


def skew_matrix_to_rotmat(skew: torch.Tensor) -> torch.Tensor:
    return rotvec_to_rotmat(skew_matrix_to_vector(skew))


def local_log(point: torch.Tensor, base_point: torch.Tensor) -> torch.Tensor:
    """Left-invariant log of ``point`` at ``base_point`` (skew matrix)."""
    return rotmat_to_skew_matrix(rot_transpose(base_point) @ point)


def geodesic_dist(mat_1: torch.Tensor, mat_2: torch.Tensor) -> torch.Tensor:
    """Geodesic distance ``|Log(R1^T R2)|_F`` (so3_sde.py:848-860)."""
    a = rotmat_to_skew_matrix(rot_transpose(mat_1) @ mat_2)
    return torch.sqrt(torch.diagonal(a @ rot_transpose(a), dim1=-2, dim2=-1).sum(-1))


def rot_vf(mat_t: torch.Tensor, mat_1: torch.Tensor) -> torch.Tensor:
    """Vector field ``Log_{mat_t}(mat_1)`` as a rotation vector."""
    return rotmat_to_rotvec(rot_transpose(mat_t) @ mat_1)


def geodesic_t(t, mat: torch.Tensor, base_mat: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation ``Exp_{base}(t Log_{base}(mat))`` (so3_sde.py:886-911)."""
    return base_mat @ rotvec_to_rotmat(t * rot_vf(base_mat, mat))


def random_rotmat(
    generator: torch.Generator,
    shape: tuple[int, ...] = (),
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Haar-uniform random rotation matrices via normalised quaternions."""
    quats = torch.randn((*shape, 4), generator=generator, dtype=dtype, device=device)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    return rotquat_to_rotmat(quats)
