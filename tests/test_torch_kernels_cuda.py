"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. On a machine with one:
    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from romp_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_plain
from romp_tpu_torch.ops.fused_chain import (
    basic_chain, basic_chain_plain, conv_pass, conv_pass_plain,
)
from romp_tpu_torch.ops.lbs import skinning, skinning_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("N,V", [(3, 1000), (64, 6890), (13, 129)])
def test_skinning_kernel_matches_plain(dev, N, V):
    g = torch.Generator().manual_seed(N)
    a16 = torch.randn(N, 16, 24, generator=g).to(dev)
    w = torch.rand(V, 24, generator=g).to(dev)
    vpos = torch.randn(N, 3, V, generator=g).to(dev)
    before = skinning.launches
    out = skinning(a16, w, vpos)
    torch.cuda.synchronize()
    assert skinning.launches == before + 1
    assert _rel(out, skinning_plain(a16, w, vpos)) <= 1e-4


def test_skinning_kernel_rejects_bad_operands(dev):
    a16 = torch.zeros(2, 16, 24, device=dev)
    w = torch.zeros(10, 24, device=dev)
    with pytest.raises(ValueError):
        skinning(a16.double(), w.double(), torch.zeros(2, 3, 10, device=dev))
    with pytest.raises(ValueError):
        skinning(a16, w, torch.zeros(2, 10, 3, device=dev).transpose(1, 2))


def _chain_operands(g, blocks, C, dev):
    w = (torch.randn(blocks, 2, 3 * C, 3 * C, generator=g) * 0.05).to(
        torch.bfloat16).to(dev)
    sc = (1 + 0.1 * torch.randn(blocks, 2, C, generator=g)).to(dev)
    sh = (0.1 * torch.randn(blocks, 2, C, generator=g)).to(dev)
    return w, sc, sh


@pytest.mark.parametrize("B,C,H,W", [(2, 32, 128, 128), (2, 256, 16, 16),
                                     (1, 16, 13, 7), (2, 40, 20, 33)])
def test_chain_kernel_matches_plain(dev, B, C, H, W):
    """Each conv pass on the same input within 5e-4 relative
    (tests/test_pallas_fuse.py:62). Across passes the bf16 rounding of each
    conv input turns f32 summation-order noise into a bf16 step now and
    then, so the whole chain is held to 5e-3, and to exactly its passes."""
    g = torch.Generator().manual_seed(C + H)
    blocks = 4
    x = torch.randn(B, C, H, W, generator=g).to(dev)
    w, sc, sh = _chain_operands(g, blocks, C, dev)
    y = x
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for n in range(blocks):
            h = None
            for j in range(2):
                args = (y, w[n, j], sc[n, j], sh[n, j], None) if j == 0 else (
                    h, w[n, j], sc[n, j], sh[n, j], y)
                before = conv_pass.launches
                out = conv_pass(*args)
                torch.cuda.synchronize()
                assert conv_pass.launches == before + 1
                assert _rel(out, conv_pass_plain(*args)) <= 5e-4
                h = out
            y = h
        full = basic_chain(x, w, sc, sh, blocks)
        assert torch.equal(full, y)
        assert _rel(full, basic_chain_plain(x, w, sc, sh, blocks)) <= 5e-3


@pytest.mark.parametrize("B,C,H,W,G,Cout", [(8, 32, 128, 128, 8, 32),
                                            (3, 12, 13, 29, 3, 40)])
def test_deform_kernel_matches_plain(dev, B, C, H, W, G, Cout):
    """TRACE's shape, and a ragged one (pixel tail, two output tiles, Cg=4
    of 3 groups). Offsets N(0, 2^2) cross the border. Bar 1e-4 of max|ref|:
    f32 summation order."""
    g = torch.Generator().manual_seed(B * C + H)
    x = torch.randn(B, C, H, W, generator=g).to(dev)
    off = (torch.randn(B, G * 18, H, W, generator=g) * 2.0).to(dev)
    w = (torch.randn(Cout, C, 3, 3, generator=g) * 0.1).to(dev)
    before = deform_conv2d.launches
    out = deform_conv2d(x, off, w, deform_groups=G)
    torch.cuda.synchronize()
    assert deform_conv2d.launches == before + 1
    assert _rel(out, deform_conv2d_plain(x, off, w, deform_groups=G)) <= 1e-4


def test_deform_kernel_zero_offsets_is_conv(dev):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 32, 40, 24, generator=g).to(dev)
    w = torch.randn(32, 32, 3, 3, generator=g).to(dev)
    off = torch.zeros(2, 8 * 18, 40, 24, device=dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = torch.nn.functional.conv2d(x, w, padding=1)
    assert _rel(deform_conv2d(x, off, w), ref) <= 1e-4


def test_deform_kernel_rejects_bad_operands(dev):
    x = torch.zeros(1, 16, 8, 8, device=dev)
    w = torch.zeros(16, 16, 3, 3, device=dev)
    with pytest.raises(ValueError):       # offsets for G=4, called with 8
        deform_conv2d(x, torch.zeros(1, 4 * 18, 8, 8, device=dev), w)
    with pytest.raises(ValueError):
        deform_conv2d(x.half(), torch.zeros(1, 8 * 18, 8, 8, device=dev), w)
