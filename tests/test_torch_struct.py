"""Frames -> atom37 and the physicality filter of the PyTorch port.

``atom37_from_frames`` is held at 2e-3 Angstrom against the reference's
recorded atoms (tests/test_data/golden_so3/atom37_reference.npz, the
tolerance of tests/test_golden_atom37.py) and against the JAX package on
random frames. The filter's masks must be identical to both the port's
numpy version and the JAX package's device filter.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.struct.atoms import atom37_from_frames, atom37_mask
from se3diff_torch.struct.physics import filter_unphysical_masks, filter_unphysical_masks_device
from se3diff_torch.struct.residues import (
    ATOM37_C, ATOM37_CA, ATOM37_CB, ATOM37_N, ATOM37_O, sequence_to_aatype,
)
from se3diff_tpu.ops import so3 as jso3
from se3diff_tpu.struct import atoms as jatoms
from se3diff_tpu.struct import physics as jphysics
from tests.test_physics_filter import _frames

GOLDEN = Path(__file__).parent / "test_data" / "golden_so3" / "atom37_reference.npz"


def test_atom37_matches_reference_golden():
    with np.load(GOLDEN) as d:
        golden = {k: d[k] for k in d}
    aatype = sequence_to_aatype(str(golden["seq"]))
    ours, mask = atom37_from_frames(
        torch.from_numpy(golden["pos"] / 10.0).float(),
        torch.from_numpy(golden["rot"]).float(), aatype,
    )
    ref_mask = golden["mask"].astype(bool)
    for slot in (ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_O, ATOM37_CB):
        sel = ref_mask[:, slot] & mask.numpy()[:, slot]
        assert sel.any()
        np.testing.assert_allclose(
            ours.numpy()[sel, slot], golden["atom37"][sel, slot], atol=2e-3, err_msg=str(slot)
        )
        np.testing.assert_array_equal(mask.numpy()[:, slot], ref_mask[:, slot])
    np.testing.assert_array_equal(mask.numpy(), atom37_mask(aatype))


def test_atom37_matches_jax_on_random_frames(rng):
    seq = "GYDPETGTWGAC"
    aatype = sequence_to_aatype(seq)
    pos = rng.standard_normal((3, len(seq), 3)).astype(np.float32)
    q = rng.standard_normal((3, len(seq), 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.asarray(jso3.rotquat_to_rotmat(jnp.asarray(q)), np.float32)
    want, want_mask = jatoms.atom37_from_frames(jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(aatype))
    got, got_mask = atom37_from_frames(torch.from_numpy(pos), torch.from_numpy(rot), aatype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-3)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("M,seed,chunk", [(24, 0, 32), (37, 2, 8)])
def test_filter_masks_identical(M, seed, chunk):
    atom37, mask = _frames(M=M, seed=seed)
    ok = filter_unphysical_masks(atom37, mask)
    want = ok[0] & ok[1] & ok[2]
    got = filter_unphysical_masks_device(torch.from_numpy(atom37).float(), mask, frame_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jphysics.filter_unphysical_masks_device(atom37, mask))
    )
    for a, b in zip(ok, jphysics.filter_unphysical_masks(atom37, mask)):
        np.testing.assert_array_equal(a, b)
    assert not want[3] and not want[7]  # the injected defects are caught
