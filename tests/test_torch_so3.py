"""SO(3) algebra of the PyTorch port against ``se3diff_tpu.ops.so3``.

The same numpy inputs (random, near angle 0, near angle pi) go through both
packages. In float64 the two must agree to 1e-9: the formulas are the same,
only the libraries' elementwise kernels differ (a few ulps). In float32 the
tolerance is 2e-5: the pi branch takes square roots of ``(1 + R_ii)/2``
close to 0, which amplifies float32 rounding of ``R``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.ops import so3 as tso3
from se3diff_tpu.ops import so3 as jso3

TOL = {np.float64: 1e-9, np.float32: 2e-5}


def _rotvecs(kind: str, rng: np.random.Generator, n: int = 64) -> np.ndarray:
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    if kind == "random":
        angles = rng.uniform(0.0, np.pi, n)
    elif kind == "zero":
        angles = np.concatenate([np.zeros(4), 10.0 ** rng.uniform(-10, -4, n - 4)])
    else:  # "pi": inside the pi branch (|angle - pi| < 1e-2)
        angles = np.pi - 10.0 ** rng.uniform(-6, -2.2, n)
    return axes * angles[:, None]


def _both(fn_name, *args, dtype):
    jax_out = getattr(jso3, fn_name)(*(jnp.asarray(a.astype(dtype)) for a in args))
    torch_out = getattr(tso3, fn_name)(*(torch.from_numpy(a.astype(dtype)) for a in args))
    return jax_out, torch_out


def _close(jax_out, torch_out, dtype):
    if isinstance(jax_out, tuple):
        for a, b in zip(jax_out, torch_out):
            _close(a, b, dtype)
        return
    np.testing.assert_allclose(
        torch_out.numpy(), np.asarray(jax_out, dtype), atol=TOL[dtype], rtol=0
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["random", "zero", "pi"])
def test_exp_and_log_maps_match(rng, kind, dtype):
    v = _rotvecs(kind, rng)
    _close(*_both("rotvec_to_rotmat", v, dtype=dtype), dtype)
    R = np.array(jso3.rotvec_to_rotmat(jnp.asarray(v)))
    for name in ("rotmat_to_rotvec", "angle_from_rotmat", "rotmat_to_skew_matrix"):
        _close(*_both(name, R, dtype=dtype), dtype)


@pytest.mark.parametrize("kind", ["random", "zero", "pi"])
def test_composition_helpers_match(rng, kind):
    dtype = np.float64
    v, w = _rotvecs(kind, rng), _rotvecs("random", rng)
    R1 = np.array(jso3.rotvec_to_rotmat(jnp.asarray(v)))
    R2 = np.array(jso3.rotvec_to_rotmat(jnp.asarray(w)))
    _close(*_both("apply_rotvec_to_rotmat", R1, w, dtype=dtype), dtype)
    _close(*_both("geodesic_dist", R1, R2, dtype=dtype), dtype)
    _close(*_both("rot_vf", R1, R2, dtype=dtype), dtype)
    _close(*_both("local_log", R1, R2, dtype=dtype), dtype)
    _close(*_both("vector_to_skew_matrix", v, dtype=dtype), dtype)
    _close(*_both("skew_matrix_to_rotmat", np.array(jso3.vector_to_skew_matrix(v)), dtype=dtype), dtype)
    scale = np.full((len(v), 1), 0.3)
    _close(*_both("scale_rotmat", R1, scale, dtype=dtype), dtype)
    jax_g = jso3.geodesic_t(0.4, jnp.asarray(R2), jnp.asarray(R1))
    torch_g = tso3.geodesic_t(0.4, torch.tensor(R2), torch.tensor(R1))
    _close(jax_g, torch_g, dtype)


def test_quaternion_conversions_match(rng):
    dtype = np.float64
    q = rng.standard_normal((64, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [1e-9, 0, 0, 1], [-1, 1e-8, 0, 0]]
    _close(*_both("rotquat_to_rotvec", q, dtype=dtype), dtype)
    _close(*_both("rotquat_to_rotmat", q, dtype=dtype), dtype)


def test_random_rotmat_is_a_rotation():
    # 1e-6: the quaternion axis is normalised as q / (|q| + 1e-7), as in the
    # JAX package, so R is orthogonal only to about 1e-7 relative.
    R = tso3.random_rotmat(torch.Generator().manual_seed(0), (256,), dtype=torch.float64)
    eye = torch.eye(3, dtype=torch.float64).expand(256, 3, 3)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, atol=1e-6, rtol=0)
    torch.testing.assert_close(
        torch.linalg.det(R), torch.ones(256, dtype=torch.float64), atol=1e-6, rtol=0
    )
