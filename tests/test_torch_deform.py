"""The port's deformable conv (plain version, which the CUDA kernel is held
to on the card) against the JAX package's: the XLA formulation and the
Pallas kernel in interpret mode. Inputs are made with numpy from a seed;
the port's NCHW / OIHW layout is transposed to JAX's NHWC / HWIO."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from romp_tpu.ops.deform_conv import deform_conv2d as jax_deform
from romp_tpu.ops.pallas_deform import deform_conv2d_pallas
from romp_tpu_torch.ops.deform_conv import (
    deform_conv2d, deform_conv2d_plain, deform_smem, scratch_floats,
)
from romp_tpu_torch.ops.lbs import split_tf32_matmul

torch.set_num_threads(2)


def _inputs(seed, B, C, H, W, G, Cout, sigma):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, H, W).astype(np.float32)
    off = (rng.randn(B, G * 2 * 9, H, W) * sigma).astype(np.float32)
    w = (rng.randn(Cout, C, 3, 3) * 0.1).astype(np.float32)
    return x, off, w


def _jax_layout(x, off, w):
    return (jnp.asarray(x.transpose(0, 2, 3, 1)),
            jnp.asarray(off.transpose(0, 2, 3, 1)),
            jnp.asarray(w.transpose(2, 3, 1, 0)))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("B,C,H,W,G,Cout", [(2, 16, 8, 8, 4, 12),
                                            (2, 16, 6, 10, 4, 12)])
def test_plain_matches_jax(reference, B, C, H, W, G, Cout):
    """Offsets N(0, 1.5^2), so samples cross the border; bar 2e-4, the JAX
    package's own Pallas-vs-XLA bar (tests/test_deform_conv.py:80)."""
    x, off, w = _inputs(B * H + W, B, C, H, W, G, Cout, 1.5)
    jx, joff, jw = _jax_layout(x, off, w)
    if reference == "xla":
        ref = jax_deform(jx, joff, jw, deform_groups=G)
    else:
        ref = deform_conv2d_pallas(jx, joff, jw, deform_groups=G,
                                   interpret=True)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    out = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                        torch.from_numpy(w), deform_groups=G)
    assert out.shape == (B, Cout, H, W)
    assert _rel(out.numpy(), ref) <= 2e-4


def test_zero_offsets_are_conv2d():
    x, off, w = _inputs(0, 2, 16, 9, 7, 8, 5, 0.0)
    out = deform_conv2d_plain(torch.from_numpy(x), torch.from_numpy(off),
                              torch.from_numpy(w), deform_groups=8)
    ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert _rel(out, ref) <= 1e-5


def test_integer_offset_is_shifted_conv():
    """A uniform offset (dy, dx) = (0, 1) is a conv of the input shifted one
    pixel left (tests/test_deform_conv.py:28-45)."""
    rng = np.random.RandomState(1)
    B, C, H, W, Co = 1, 8, 12, 12, 4
    x = np.zeros((B, C, H, W), np.float32)
    x[:, :, 2:-2, 2:-2] = rng.randn(B, C, H - 4, W - 4)
    w = rng.randn(Co, C, 3, 3).astype(np.float32)
    off = np.zeros((B, 2 * 9, H, W), np.float32)
    off[:, 1::2] = 1.0
    out = deform_conv2d_plain(torch.from_numpy(x), torch.from_numpy(off),
                              torch.from_numpy(w), deform_groups=1).numpy()
    shifted = np.roll(x, -1, axis=3)
    shifted[..., -1] = 0
    ref = F.conv2d(torch.from_numpy(shifted), torch.from_numpy(w),
                   padding=1).numpy()
    np.testing.assert_allclose(out[..., 1:-1, 1:-1], ref[..., 1:-1, 1:-1],
                               atol=1e-4)


def test_groups_are_independent():
    """Group 1 shifted by dy = 2 moves only the channels it steers
    (tests/test_deform_conv.py:58-74)."""
    rng = np.random.RandomState(2)
    B, C, H, W, Co, G = 1, 8, 10, 10, 8, 2
    x = rng.randn(B, C, H, W).astype(np.float32)
    w = np.zeros((Co, C, 3, 3), np.float32)
    w[0, 0, 1, 1] = 1.0       # out 0 reads channel 0 (group 0), centre tap
    w[1, 7, 1, 1] = 1.0       # out 1 reads channel 7 (group 1)
    off = np.zeros((B, G * 2 * 9, H, W), np.float32)
    off[:, 18::2] = 2.0       # group 1's dy
    out = deform_conv2d_plain(torch.from_numpy(x), torch.from_numpy(off),
                              torch.from_numpy(w), deform_groups=G).numpy()
    np.testing.assert_allclose(out[0, 0, 3:-3, 3:-3], x[0, 0, 3:-3, 3:-3],
                               atol=1e-5)
    np.testing.assert_allclose(out[0, 1, 3:-3, 3:-3], x[0, 7, 5:-1, 3:-3],
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    x, off, w = _inputs(3, 1, 8, 5, 5, 2, 3, 1.0)
    before = deform_conv2d.launches
    args = (torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(w))
    assert torch.equal(deform_conv2d(*args, deform_groups=2),
                       deform_conv2d_plain(*args, deform_groups=2))
    assert deform_conv2d.launches == before


# --- the kernel's arithmetic and buffers (csrc/deform_conv.cu) ------------

def test_split_tf32_meets_the_bar_where_one_tf32_product_misses():
    """K = 9 x 32 (TRACE's taps x channels): the samples (bilinear blends of
    N(0, 1) features) against 0.1 N(0, 1) weights, as in chip_smoke.py. The
    3-term split product lands within 1e-5 of max|ref| of the f32 product;
    one TF32 product does not."""
    rng = np.random.RandomState(4)
    corners = rng.randn(4, 4096, 288).astype(np.float32)
    wts = rng.dirichlet(np.ones(4), size=(4096, 288)).astype(np.float32)
    samples = torch.from_numpy(np.einsum("cpk,pkc->pk", corners, wts)
                               .astype(np.float32))
    w = torch.from_numpy((rng.randn(288, 32) * 0.1).astype(np.float32))
    ref = samples.double() @ w.double()
    scale = float(ref.abs().max())
    err3 = float((split_tf32_matmul(samples, w).double() - ref).abs().max())
    err1 = float((split_tf32_matmul(samples, w, terms=1).double() - ref)
                 .abs().max())
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-5 * scale


@pytest.mark.parametrize("C,G", [(32, 8), (16, 2), (12, 3), (40, 4), (64, 64),
                                 (256, 8), (6, 6)])
def test_deform_buffers(C, G):
    """Shared memory within the 232,448 bytes a CTA may take for any group
    width (at TRACE's C = 32, G = 8: 72 KB, so three CTAs share an SM);
    the scratch holds the weight fragments and x regrouped."""
    smem = deform_smem(G, C // G)
    assert smem <= 232448
    if (C, G) == (32, 8):
        assert 3 * (smem + 1024) <= 228 * 1024
    B, H, W, Cout = 2, 9, 17, 24
    frags = -(-Cout // 32) * 9 * -(-C // 32) * 4 * 4 * 32 * 4
    assert scratch_floats(B, C, H, W, Cout) == frags + B * C * H * W
    assert frags % 4 == 0       # x's regrouped copy starts 16-byte aligned


@pytest.mark.parametrize("B,C,H,W,G,Cout", [(2, 16, 8, 8, 4, 12),
                                            (2, 32, 12, 10, 8, 16)])
def test_plain_bf16_matches_jax(B, C, H, W, G, Cout):
    """bf16 x and weight, f32 offsets (TRACE's bf16-activation path,
    `romp_tpu/models/trace.py:198-201`): the plain twin rounds where JAX's
    `deform_conv2d` does (the fractions and 1 - f, the row blend, the
    column blend, to bf16; the weight product in f32), so the two agree to
    f32 summation order: 1e-5 of max|ref| (measured 1.3e-7 and 2.6e-7),
    where JAX's own bf16 and f32 results are over 1e-3 apart. f32 out."""
    x, off, w = _inputs(B * H + W + 1, B, C, H, W, G, Cout, 1.5)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    jx = jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1)).astype(
        jnp.bfloat16)
    jw = jnp.asarray(wb.float().numpy().transpose(2, 3, 1, 0)).astype(
        jnp.bfloat16)
    joff = jnp.asarray(off.transpose(0, 2, 3, 1))
    ref = np.asarray(jax_deform(jx, joff, jw, deform_groups=G)).transpose(
        0, 3, 1, 2)
    f32 = np.asarray(jax_deform(*_jax_layout(x, off, w), deform_groups=G)
                     ).transpose(0, 3, 1, 2)
    out = deform_conv2d(xb, torch.from_numpy(off), wb, deform_groups=G)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert _rel(out.numpy(), ref) <= 1e-5
    assert _rel(f32, ref) > 1e-3          # the bf16 rounding really happens


def test_plain_bf16_needs_bf16_weight():
    x, off, w = _inputs(0, 1, 8, 5, 5, 2, 4, 1.0)
    with pytest.raises(ValueError, match="bf16 weight"):
        deform_conv2d_plain(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(off), torch.from_numpy(w), 2)
