"""Port parity: romp_tpu_torch.ops.rotations vs romp_tpu.ops.rotations (f32,
atol 1e-5), same numpy inputs through both."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from romp_tpu.ops import rotations as jrot
from romp_tpu_torch.ops import rotations as trot

torch.set_num_threads(2)
ATOL = 1e-5


def _both(name, x):
    ours = getattr(trot, name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jrot, name)(jnp.asarray(x)))
    return ours, ref


def _axis_angles(seed, n=256):
    aa = np.random.RandomState(seed).randn(n, 3).astype(np.float32) * 1.5
    aa[0] = 0.0                      # zero rotation (the 1e-8 quirk)
    aa[1] = [np.pi, 0.0, 0.0]        # 180 degrees: the other quaternion cases
    aa[2] = [0.0, -np.pi, 0.0]
    aa[3] = [0.0, 0.0, np.pi - 1e-3]
    return aa


def _rotations(seed):
    return np.array(jrot.axis_angle_to_matrix(jnp.asarray(_axis_angles(seed))))


@pytest.mark.parametrize("name,make", [
    ("axis_angle_to_matrix", lambda: _axis_angles(0).reshape(8, 32, 3)),
    ("rot6d_to_matrix",
     lambda: np.random.RandomState(1).randn(4, 32, 6).astype(np.float32)),
    ("matrix_to_quaternion", lambda: _rotations(2)),
    ("matrix_to_axis_angle", lambda: _rotations(3)),
    ("rot6d_to_axis_angle",
     lambda: np.random.RandomState(4).randn(16, 22 * 6).astype(np.float32)),
    ("quaternion_to_matrix",
     lambda: np.random.RandomState(6).randn(8, 16, 4).astype(np.float32)),
    ("matrix_to_rot6d", lambda: _rotations(7).reshape(16, 16, 3, 3)),
])
def test_rotation_matches_jax(name, make):
    ours, ref = _both(name, make())
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_quaternion_to_axis_angle_matches_jax_with_nan_flush():
    rng = np.random.RandomState(5)
    q = rng.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]          # sin(theta) == 0: the k = 2 branch
    q[1] = [-1.0, 0.0, 0.0, 0.0]
    q[2] = [np.nan, 0.3, 0.2, 0.1]       # NaN -> flushed to 0
    q[3] = [0.5, np.nan, 0.0, 0.0]
    ours, ref = _both("quaternion_to_axis_angle", q)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=ATOL)
