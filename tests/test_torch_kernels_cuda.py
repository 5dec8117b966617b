"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. On a machine with one:
    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from romp_tpu_torch.ops.deform_conv import (
    bwd_global_share, bwd_plan, deform_conv2d, deform_conv2d_backward,
    deform_conv2d_bwd_plain, deform_conv2d_plain,
)
from romp_tpu_torch.ops.fused_chain import (
    basic_chain, basic_chain_plain, conv_pass, conv_pass_plain,
)
from romp_tpu_torch.ops.lbs import (
    skinning, skinning_backward, skinning_bwd_plain, skinning_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("N,V", [(3, 1000), (64, 6890), (13, 129),
                                 (1, 129), (1, 6890), (13, 6890),
                                 (4096, 129), (4096, 6890)])
def test_skinning_kernel_matches_plain(dev, N, V):
    """Ragged person and vertex tiles (N = 1, 13; V = 129, 1000, 6890:
    16-byte and 8-byte aligned v_posed rows) and the main path's shapes.
    Bar 1e-4 of max|ref|: split TF32 keeps about 1e-7."""
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
                                     (1, 16, 13, 7), (2, 40, 20, 33),
                                     (64, 32, 128, 128), (1, 256, 16, 16)])
def test_chain_kernel_matches_plain(dev, B, C, H, W):
    """Each conv pass on the same input within 5e-4 relative
    (tests/test_pallas_fuse.py:62). Across passes the bf16 rounding of each
    conv input turns f32 summation-order noise into a bf16 step now and
    then, so the whole chain is held to 5e-3, and to exactly its passes.
    (2, 40, 20, 33) and (1, 256, 16, 16) take the K-split plan (second,
    reducing kernel); (64, 32, 128, 128) is the large-batch plan."""
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


def test_chain_kernel_rejects_bad_operands(dev):
    g = torch.Generator().manual_seed(5)
    w, sc, sh = _chain_operands(g, 1, 12, dev)
    x = torch.zeros(1, 12, 8, 8, device=dev)
    with pytest.raises(ValueError):       # C not a multiple of 8
        basic_chain(x, w, sc, sh, 1)
    w, sc, sh = _chain_operands(g, 1, 16, dev)
    x = torch.zeros(1, 16, 8, 8, device=dev)
    with pytest.raises(ValueError):       # f32 weights
        conv_pass(x, w[0, 0].float(), sc[0, 0], sh[0, 0])
    with pytest.raises(ValueError):       # non-contiguous input
        conv_pass(x.transpose(2, 3), w[0, 0], sc[0, 0], sh[0, 0])
    with pytest.raises(ValueError):       # residual of another shape
        conv_pass(x, w[0, 0], sc[0, 0], sh[0, 0], residual=x[:, :8])


@pytest.mark.parametrize("B,C,H,W,G,Cout", [(8, 32, 128, 128, 8, 32),
                                            (3, 12, 13, 29, 3, 40),
                                            (2, 16, 9, 17, 2, 24),
                                            (1, 40, 7, 9, 4, 8),
                                            (1, 64, 7, 9, 8, 40)])
def test_deform_kernel_matches_plain(dev, B, C, H, W, G, Cout):
    """TRACE's shape, and ragged ones: pixel tails, two output tiles, Cg=4
    of 3 groups; Cg = 8 (float4 gathers, width read at run time) and Cg =
    10 (scalar gathers) over two 32-channel chunks. Offsets N(0, 2^2) cross
    the border. Bar 1e-4 of max|ref|: split TF32 keeps about 1e-6."""
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


@pytest.mark.parametrize("B,C,H,W,blocks", [
    (2, 32, 128, 128, 4), (2, 256, 16, 16, 4), (1, 16, 13, 7, 3),
    (2, 40, 20, 33, 2), (64, 64, 64, 64, 4), (1, 256, 16, 16, 1)])
def test_chain_kernel_bf16_matches_plain(dev, B, C, H, W, blocks):
    """The bf16-in / bf16-out variant: bit-equal to the f32 kernel on the
    widened input, rounded to bf16 (the same plan and passes; block 0's
    residual widened exactly), and within the chain's 5e-3 of its plain
    twin, plus a bf16 step (2^-8 of max|ref|) for the final rounding.
    K-split plans at (2, 40, 20, 33) and (1, 256, 16, 16); one, two and
    three blocks (the f32 buffers' alternation)."""
    g = torch.Generator().manual_seed(C + H + blocks)
    x = torch.randn(B, C, H, W, generator=g).to(torch.bfloat16).to(dev)
    w, sc, sh = _chain_operands(g, blocks, C, dev)
    before = basic_chain.bf16_launches
    out = basic_chain(x, w, sc, sh, blocks)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert basic_chain.bf16_launches == before + 2 * blocks
    assert torch.equal(out, basic_chain(x.float(), w, sc, sh, blocks).to(
        torch.bfloat16))
    ref = basic_chain_plain(x, w, sc, sh, blocks)
    assert ref.dtype == torch.bfloat16
    assert _rel(out.float(), ref.float()) <= 5e-3 + 2.0 ** -8


@pytest.mark.parametrize("B,C,H,W,G,Cout", [(8, 32, 128, 128, 8, 32),
                                            (3, 12, 13, 29, 3, 40),
                                            (2, 16, 9, 17, 2, 24),
                                            (1, 40, 7, 9, 4, 8),
                                            (1, 64, 7, 9, 8, 40)])
def test_deform_kernel_bf16_matches_plain(dev, B, C, H, W, G, Cout):
    """The bf16 variant (bf16 x and weight, f32 offsets, f32 out): the same
    rounding points as the plain twin, so the samples agree bit for bit and
    the outputs to f32 summation order (bf16 MMAs against the einsum): 1e-4
    of max|ref|. Shapes as the f32 kernel's test."""
    g = torch.Generator().manual_seed(B * C + H + 1)
    x = torch.randn(B, C, H, W, generator=g).to(torch.bfloat16).to(dev)
    off = (torch.randn(B, G * 18, H, W, generator=g) * 2.0).to(dev)
    w = (torch.randn(Cout, C, 3, 3, generator=g) * 0.1).to(
        torch.bfloat16).to(dev)
    before = (deform_conv2d.launches, deform_conv2d.bf16_launches)
    out = deform_conv2d(x, off, w, deform_groups=G)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert (deform_conv2d.launches, deform_conv2d.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(out, deform_conv2d_plain(x, off, w, deform_groups=G)) <= 1e-4


def test_bf16_kernels_reject_other_dtypes(dev):
    """No quiet casts: a dtype a kernel does not take raises."""
    x = torch.zeros(1, 16, 8, 8, device=dev)
    w = torch.zeros(16, 16, 3, 3, device=dev)
    off = torch.zeros(1, 8 * 18, 8, 8, device=dev)
    with pytest.raises(ValueError):       # bf16 x, f32 weight
        deform_conv2d(x.bfloat16(), off, w)
    with pytest.raises(ValueError):       # bf16 offsets
        deform_conv2d(x.bfloat16(), off.bfloat16(), w.bfloat16())
    g = torch.Generator().manual_seed(6)
    cw, sc, sh = _chain_operands(g, 1, 16, dev)
    with pytest.raises(ValueError):       # f16 activations
        basic_chain(x.half(), cw, sc, sh, 1)


def test_kernel_wrappers_raise_under_grad(dev):
    """The chain kernels and the deform's bf16 variant are forward only:
    under grad mode with an operand that requires grad each wrapper raises
    (its output would carry no graph); under no_grad the same call runs.
    (Skinning and the f32 deform have their backward kernels: the tests
    below.)"""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(1, 16, 8, 8, generator=g).to(dev).requires_grad_()
    cw, sc, sh = _chain_operands(g, 1, 16, dev)
    dw = torch.randn(16, 16, 3, 3, generator=g).to(dev)
    off = torch.zeros(1, 8 * 18, 8, 8, device=dev)
    xb = x.detach().bfloat16().requires_grad_()
    calls = [lambda: basic_chain(x, cw, sc, sh, 1),
             lambda: basic_chain(xb, cw, sc, sh, 1),
             lambda: conv_pass(x, cw[0, 0], sc[0, 0], sh[0, 0]),
             lambda: deform_conv2d(xb, off, dw.bfloat16())]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("N,V", [(1, 6890), (4, 6890), (37, 6890),
                                 (512, 6890), (37, 129), (5, 1000)])
def test_skinning_backward_kernel_matches_plain(dev, N, V):
    """The backward kernel (dA16, dv) against `skinning_bwd_plain` on the
    card: ragged person chunks (N = 1, 37, 5), ragged vertex tiles (V =
    129, 1000) and the train step's N = 64 x 8 = 512. Bar 1e-4 of
    max|ref|, the forward's; rows 12-15 of dA16 are zero; one launch."""
    g = torch.Generator().manual_seed(N + V)
    a16 = torch.randn(N, 16, 24, generator=g).to(dev)
    w = torch.rand(V, 24, generator=g).to(dev)
    w /= w.sum(1, keepdim=True)
    vpos = torch.randn(N, 3, V, generator=g).to(dev)
    cot = torch.randn(N, 3, V, generator=g).to(dev)
    before = skinning_backward.launches
    da, dv = skinning_backward(a16, w, vpos, cot)
    torch.cuda.synchronize()
    assert skinning_backward.launches == before + 1
    ra, rv = skinning_bwd_plain(a16, w, vpos, cot)
    assert _rel(da, ra) <= 1e-4 and _rel(dv, rv) <= 1e-4
    assert not da[:, 12:].any()


@pytest.mark.parametrize("N,V", [(2, 129), (4, 300)])
def test_skinning_autograd_on_card_is_the_kernel_and_exact(dev, N, V):
    """Autograd through `skinning` on CUDA runs both kernels; its gradient
    matches autograd of `skinning_plain`, and a central difference of the
    forward kernel (exact for this bilinear map up to f32 rounding) along a
    random direction in (a16, v_posed): 1e-4 relative. The lbs weights get
    no gradient."""
    g = torch.Generator().manual_seed(V)
    a16 = torch.randn(N, 16, 24, generator=g).to(dev).requires_grad_()
    w = torch.rand(V, 24, generator=g).to(dev)
    vpos = torch.randn(N, 3, V, generator=g).to(dev).requires_grad_()
    cot = torch.randn(N, 3, V, generator=g).to(dev)
    fwd, bwd = skinning.launches, skinning_backward.launches
    out = skinning(a16, w, vpos)
    (out * cot).sum().backward()
    assert (skinning.launches, skinning_backward.launches) == (fwd + 1,
                                                               bwd + 1)
    a2, v2 = a16.detach().clone().requires_grad_(), vpos.detach().clone(
    ).requires_grad_()
    (skinning_plain(a2, w, v2) * cot).sum().backward()
    assert _rel(a16.grad, a2.grad) <= 1e-4 and _rel(vpos.grad, v2.grad) <= 1e-4
    da = torch.randn(N, 16, 24, generator=g).to(dev)
    dvp = torch.randn(N, 3, V, generator=g).to(dev)
    eps = 0.5
    with torch.no_grad():
        fd = ((skinning(a16 + eps * da, w, vpos + eps * dvp) * cot).sum()
              - (skinning(a16 - eps * da, w, vpos - eps * dvp) * cot).sum()
              ) / (2 * eps)
    an = (a16.grad * da).sum() + (vpos.grad * dvp).sum()
    assert abs(float(fd - an)) <= 1e-4 * float(
        (a16.grad * da).abs().sum() + (vpos.grad * dvp).abs().sum())


def _deform_grad_operands(g, B, C, H, W, G, Cout, dev, sigma=2.0):
    x = torch.randn(B, C, H, W, generator=g).to(dev)
    off = (torch.randn(B, G * 18, H, W, generator=g) * sigma).to(dev)
    w = (torch.randn(Cout, C, 3, 3, generator=g) * 0.1).to(dev)
    gout = torch.randn(B, Cout, H, W, generator=g).to(dev)
    return x, off, w, gout


@pytest.mark.parametrize("B,C,H,W,G,Cout", [
    (10, 32, 128, 128, 8, 32), (8, 32, 128, 128, 8, 32),
    (3, 12, 37, 29, 3, 20), (2, 40, 33, 50, 8, 36),
    (1, 72, 20, 24, 1, 40)])
def test_deform_backward_kernel_matches_plain(dev, B, C, H, W, G, Cout):
    """The backward kernel (dx, doffsets, dweight) against
    `deform_conv2d_bwd_plain` on the card: the train step's clip (T = 10)
    and the inference batch (B = 8) at TRACE's shape, and ragged shapes
    (H, W not multiples of the 8 x 16 tile, W % 4 != 0; Cg = 4, 5 and
    72, a group wider than a 32-channel chunk; C and Cout past one block
    of 32; at (1, 72, .., 40) the dW partials do not fit shared memory and
    go to device memory). Offsets N(0, 2^2): samples cross the border and
    the dx window. Bar 1e-4 of max|ref| each, the forward's (f32 sums in
    another order); one launch."""
    g = torch.Generator().manual_seed(B * H + W)
    x, off, w, gout = _deform_grad_operands(g, B, C, H, W, G, Cout, dev)
    before = deform_conv2d_backward.launches
    got = deform_conv2d_backward(x, off, w, gout, G)
    torch.cuda.synchronize()
    assert deform_conv2d_backward.launches == before + 1
    for a, r in zip(got, deform_conv2d_bwd_plain(x, off, w, gout, G)):
        assert a.shape == r.shape
        assert _rel(a, r) <= 1e-4


@pytest.mark.parametrize("case,B,C,H,W,G,Cout,sigma", [
    ("sigma 8", 2, 32, 64, 64, 8, 32, 8.0),
    ("zero offsets", 2, 32, 64, 64, 8, 32, 0.0),
    ("ragged, Cg 2", 2, 16, 37, 45, 8, 24, 2.0)])
def test_deform_backward_kernel_offset_cases(dev, case, B, C, H, W, G,
                                             Cout, sigma):
    """The backward kernel where its dx route changes: offsets N(0, 8^2)
    send many corners past the shared-memory window (tile +- 4 pixels) to
    the global atomics; zero offsets keep every corner in it (three of the
    four corners then have weight 0); W = 45 is no multiple of the tile's
    16 columns nor of 4 (the window is flushed by scalar atomics) and Cg =
    2 gathers scalars. Each of dx, doffsets, dweight within 1e-4 of
    max|ref|; dweight and doffsets bit-equal over two runs, dx's spread
    at most 1e-6 of max|dx|."""
    g = torch.Generator().manual_seed(H * W + int(sigma))
    x, off, w, gout = _deform_grad_operands(g, B, C, H, W, G, Cout, dev,
                                            sigma)
    plan = bwd_plan(B, C, H, W, G, Cout, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    share = bwd_global_share(off, G, 1, plan)
    assert (share > 0.3) if sigma == 8.0 else (share < 0.2), (case, share)
    got = deform_conv2d_backward(x, off, w, gout, G)
    again = deform_conv2d_backward(x, off, w, gout, G)
    torch.cuda.synchronize()
    for a, r in zip(got, deform_conv2d_bwd_plain(x, off, w, gout, G)):
        assert _rel(a, r) <= 1e-4, case
    assert torch.equal(got[2], again[2]) and torch.equal(got[1], again[1])
    assert _rel(again[0], got[0]) <= 1e-6


@pytest.mark.parametrize("C,G,Cout,windowed", [
    (32, 8, 32, True), (16, 8, 24, True), (12, 3, 20, False),
    (40, 8, 36, False), (72, 1, 40, False)])
def test_backward_plan_fits_and_picks_the_window(dev, C, G, Cout, windowed):
    """The backward kernel's launch plan (csrc/deform_conv.cu `bwd_plan`,
    read through `romp_deform_conv2d_bwd_plan`): at most one CTA a tile or
    an SM; shared memory within the card's 227 KB; a window a warp where
    the channels are one chunk and G is 4, 8 or 16 (TRACE's shape: the
    largest window, its 4 rows +- 4), none otherwise; a shape whose gout
    tile alone overflows raises."""
    plan = bwd_plan(2, C, 20, 24, G, Cout, 132)
    assert plan["ctas"] == min(2 * 3 * 2, 132)
    assert plan["smem"] <= 232448 and (plan["ey"] >= 0) == windowed
    if (C, G) == (32, 8):
        assert (plan["ey"], plan["ex"], plan["wrows"]) == (4, 4, 4)
    with pytest.raises(ValueError):
        bwd_plan(1, 32, 8, 16, 8, 512, 132)


def test_deform_backward_rejects_what_it_does_not_take(dev):
    """Shapes whose smallest plan does not fit the kernel's shared memory
    raise, with no fallback (Cout = 512: gout's tile alone is 512 KB)."""
    g = torch.Generator().manual_seed(13)
    x, off, w, gout = _deform_grad_operands(g, 1, 32, 8, 16, 8, 512, dev)
    with pytest.raises(ValueError):
        deform_conv2d_backward(x, off, w, gout, 8)


def test_deform_backward_dweight_is_deterministic(dev):
    """dweight (per-CTA partials over a fixed set of tiles, summed in a
    fixed order) and doffsets (one writer each) are bit-equal from run to
    run; dx, summed with float atomics, varies in its last bits only (1e-6
    of max|dx|)."""
    g = torch.Generator().manual_seed(11)
    x, off, w, gout = _deform_grad_operands(g, 10, 32, 128, 128, 8, 32, dev)
    a = deform_conv2d_backward(x, off, w, gout, 8)
    b = deform_conv2d_backward(x, off, w, gout, 8)
    torch.cuda.synchronize()
    assert torch.equal(a[2], b[2]) and torch.equal(a[1], b[1])
    assert _rel(a[0], b[0]) <= 1e-6


def test_deform_autograd_on_card_is_the_kernel(dev):
    """Autograd through `deform_conv2d` on f32 CUDA operands runs the
    forward and the backward kernels once each, and its gradients are the
    plain backward's (1e-4 of max|ref|)."""
    g = torch.Generator().manual_seed(12)
    x, off, w, gout = _deform_grad_operands(g, 2, 32, 24, 20, 8, 32, dev)
    leaves = [t.clone().requires_grad_() for t in (x, off, w)]
    fwd, bwd = deform_conv2d.launches, deform_conv2d_backward.launches
    grads = torch.autograd.grad(deform_conv2d(*leaves, 8), leaves, gout)
    torch.cuda.synchronize()
    assert (deform_conv2d.launches, deform_conv2d_backward.launches) == (
        fwd + 1, bwd + 1)
    for a, r in zip(grads, deform_conv2d_bwd_plain(x, off, w, gout, 8)):
        assert _rel(a, r) <= 1e-4
