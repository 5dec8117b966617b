"""The port's deform backward on the CPU (`deform_conv2d_bwd_plain`, and the
autograd Function `deform_conv2d` routes through when an operand requires
grad) against JAX's VJP of the XLA `deform_conv2d` and of
`deform_conv2d_fast` (the custom_vjp around the Pallas kernel, on the CPU
as the JAX package's own tests run it). Inputs are made with numpy from a
seed; the port's NCHW / OIHW layout is transposed to JAX's NHWC / HWIO."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.ops.deform_conv import deform_conv2d as jax_deform
from romp_tpu.ops.pallas_deform import deform_conv2d_fast
from romp_tpu_torch.ops.deform_conv import (
    bwd_global_share, deform_conv2d, deform_conv2d_bwd_plain,
    deform_conv2d_plain,
)

torch.set_num_threads(2)


def _inputs(seed, B, C, H, W, G, Cout):
    """Offsets N(0, 1.5^2) (samples cross the border, some corners leave
    the image), their fractional parts kept 1e-3 or more from an integer
    (where floor jumps, the two sides' f32 coordinates could fall on either
    side); a cotangent for the output."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, H, W).astype(np.float32)
    off = rng.randn(B, G * 2 * 9, H, W) * 1.5
    frac = off - np.floor(off)
    off = np.where((frac < 1e-3) | (frac > 1 - 1e-3), off + 0.01, off)
    w = (rng.randn(Cout, C, 3, 3) * 0.1).astype(np.float32)
    g = rng.randn(B, Cout, H, W).astype(np.float32)
    return x, off.astype(np.float32), w, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_vjp(fn, x, off, w, g, G):
    """JAX's (dx, doffsets, dweight) in the port's layouts."""
    _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, G),
                     jnp.asarray(x.transpose(0, 2, 3, 1)),
                     jnp.asarray(off.transpose(0, 2, 3, 1)),
                     jnp.asarray(w.transpose(2, 3, 1, 0)))
    dx, doff, dw = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    return (np.asarray(dx).transpose(0, 3, 1, 2),
            np.asarray(doff).transpose(0, 3, 1, 2),
            np.asarray(dw).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("reference", ["xla", "fast_custom_vjp"])
@pytest.mark.parametrize("B,C,H,W,G,Cout", [(2, 16, 8, 8, 4, 12),
                                            (2, 12, 6, 10, 3, 8)])
def test_backward_matches_jax_vjp(reference, B, C, H, W, G, Cout):
    """dx, doffsets and dweight of the plain backward and of the autograd
    Function each within 1e-5 of max|ref| (f32 summation order)."""
    x, off, w, g = _inputs(B * H + W, B, C, H, W, G, Cout)
    fn = jax_deform if reference == "xla" else deform_conv2d_fast
    ref = _jax_vjp(fn, x, off, w, g, G)
    tx, toff, tw, tg = (torch.from_numpy(a) for a in (x, off, w, g))
    plain = deform_conv2d_bwd_plain(tx, toff, tw, tg, G)
    leaves = [t.clone().requires_grad_() for t in (tx, toff, tw)]
    out = deform_conv2d(*leaves, deform_groups=G)
    auto = torch.autograd.grad(out, leaves, tg)
    for name, p, a, r in zip(("dx", "doffsets", "dweight"), plain, auto,
                             ref):
        assert p.shape == r.shape, name
        assert _rel(p.numpy(), r) <= 1e-5, (name, _rel(p.numpy(), r))
        assert _rel(a.numpy(), r) <= 1e-5, (name, _rel(a.numpy(), r))


def test_forward_under_grad_is_the_plain_forward():
    x, off, w, _ = _inputs(0, 1, 8, 5, 5, 2, 4)
    args = [torch.from_numpy(a) for a in (x, off, w)]
    leaves = [t.clone().requires_grad_() for t in args]
    assert torch.equal(deform_conv2d(*leaves, deform_groups=2).detach(),
                       deform_conv2d_plain(*args, deform_groups=2))


def test_gradcheck_f64_on_a_4x4_map(monkeypatch):
    """torch.autograd.gradcheck of the Function in float64 (`.float()` taken
    as `.double()`, so the plain versions keep f64) on a 4x4 map: the
    analytic backward against finite differences."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    x, off, w, _ = _inputs(3, 1, 4, 4, 4, 2, 3)
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (x, off, w)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: deform_conv2d(a, b, c, deform_groups=2), leaves,
        eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("case,share", [
    ("zero offsets", 0.0),
    ("one sample 9.5 rows down", 2 / (46 * 46 - 1 + 2)),
    ("two lanes share a top-left corner", 1 / (46 * 46))])
def test_backward_global_share_counts_corners_outside_the_window(case,
                                                                  share):
    """`bwd_global_share` against a count by hand on a 16 x 16 map, G = 1:
    zero offsets put each of the 46 x 46 samples that fall in the image
    on one corner of weight 1, inside its window (its warp's 4 rows +- 4,
    its tile's 16 columns +- 4), each lane on a cell of its own; moving
    the centre tap of pixel (0, 5) 9.5 rows down splits it over rows 9
    and 10, both past the window's last row 7; moving that of pixel (0,
    6) one column left puts it on pixel (0, 5)'s cell, in the same warp
    (lanes 5 and 6): lane 6 loses the tag, and its one add goes to dx."""
    off = torch.zeros(1, 18, 16, 16)
    if case == "one sample 9.5 rows down":
        off[0, 8, 0, 5] = 9.5    # channel (g*9 + 4)*2 + 0: the centre's dy
    elif case == "two lanes share a top-left corner":
        off[0, 9, 0, 6] = -1.0   # the centre's dx
    plan = dict(ey=4, ex=4, wrows=4)
    assert bwd_global_share(off, 1, 1, plan) == pytest.approx(share)
    assert bwd_global_share(off, 1, 1, dict(ey=-1, ex=-1, wrows=8)) == 1.0
