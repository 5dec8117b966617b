"""The port's video losses (`romp_tpu_torch/train/video_losses.py`) against
the JAX package's: values and gradients on the same numpy inputs, in f32,
within 1e-6 (relative to max|ref|)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.train import video_losses as jvl
from romp_tpu_torch.train import video_losses as tvl

torch.set_num_threads(2)
N, T = 3, 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cases(seed):
    """name -> (float inputs that get gradients, the other inputs)."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(N, T) > 0.25
    valid[0] = True
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    aa = f(N, T, 3)
    gt_aa = f(N, T, 3)
    gt_aa[1, 0] = -aa[1, 0]           # opposite rotations
    return {
        "quaternion_angle_loss": ((aa, gt_aa),
                                  (rng.rand(N, T).astype(np.float32),)),
        "world_trans_consistency_loss": ((f(N, T, 3), f(N, T, 3)), (valid,)),
        "temporal_shape_consistency_loss": ((f(N, T, 11),), (valid,)),
        "motion_offset3d_loss": ((f(N, T, 3), f(N, T, 3)), (valid,)),
        "vel_acc_error": ((f(N, T, 3), f(N, T, 3)), (valid,)),
    }


@pytest.mark.parametrize("name", list(_cases(0)))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_jax(name, seed):
    floats, rest = _cases(seed)[name]
    jfn, tfn = getattr(jvl, name), getattr(tvl, name)
    argnums = tuple(range(len(floats)))
    ref, jgrads = jax.value_and_grad(
        lambda *a: jfn(*a[:len(floats)], *a[len(floats):]),
        argnums=argnums)(*(jnp.asarray(a) for a in floats + rest))
    leaves = [torch.from_numpy(a).requires_grad_() for a in floats]
    out = tfn(*leaves, *(torch.from_numpy(a) for a in rest))
    grads = torch.autograd.grad(out, leaves)
    assert abs(float(out.detach()) - float(ref)) <= 1e-6 * max(
        abs(float(ref)), 1.0)
    for g, jg in zip(grads, jgrads):
        assert np.isfinite(g.numpy()).all()
        assert _rel(g.numpy(), jg) <= 1e-6, _rel(g.numpy(), jg)




def test_abs_clip_passes_jax_gradient_at_its_edges():
    """`_abs_clip` against jnp.clip(jnp.abs(d), 0, 1 - 1e-7): equal values
    and gradients, exactly, at 0, at the f32 bound (half passes), past it
    (none) and inside."""
    bound = np.float32(1 - 1e-7)
    d = np.array([0.5, bound, 1.0, 0.0, -0.3, -bound, -1.0],
                 np.float32)
    t = torch.from_numpy(d).requires_grad_()
    out = tvl._abs_clip(t)
    (g,) = torch.autograd.grad(out.sum(), t)
    ref = jnp.clip(jnp.abs(jnp.asarray(d)), 0.0, 1.0 - 1e-7)
    jg = jax.grad(lambda x: jnp.sum(jnp.clip(jnp.abs(x), 0.0,
                                             1.0 - 1e-7)))(jnp.asarray(d))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_quaternion_loss_at_the_clip():
    """Equal rotations: |<q1, q2>| rounds to about 1, at, past or just
    under the clip's bound 1 - 1e-7 (which of the three can differ between
    the two sides by an ulp). The loss agrees within 1e-6 and the
    gradients, which are rounding noise scaled by acos' slope there, agree
    within 1e-5 absolute (measured 2.9e-6) and are finite."""
    rng = np.random.RandomState(4)
    aa = rng.randn(64, 3).astype(np.float32)
    w = np.ones(64, np.float32)
    ref, jgrads = jax.value_and_grad(jvl.quaternion_angle_loss,
                                     argnums=(0, 1))(
        jnp.asarray(aa), jnp.asarray(aa), jnp.asarray(w))
    a = torch.from_numpy(aa).requires_grad_()
    b = torch.from_numpy(aa.copy()).requires_grad_()
    out = tvl.quaternion_angle_loss(a, b, torch.from_numpy(w))
    grads = torch.autograd.grad(out, [a, b])
    assert abs(float(out.detach()) - float(ref)) <= 1e-6
    for g, jg in zip(grads, jgrads):
        assert np.isfinite(g.numpy()).all()
        assert np.abs(g.numpy() - np.asarray(jg)).max() <= 1e-5
