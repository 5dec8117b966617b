"""The bf16 chain's fused block design on the CPU: its launch plan at the
HRNet branch shapes, and a plain-torch emulation of its tile schedule
(halo'd windows, h over the tile +- 1 pixel with zero outside the image)
against `basic_chain_plain` on ragged shapes. The kernel itself runs only
on the card (tests/test_torch_kernels_cuda.py)."""
import pytest
import torch
import torch.nn.functional as F

from romp_tpu_torch.models.layers import bf16_round
from romp_tpu_torch.ops.fused_chain import (
    CARD_SMS, FUSED_TILES, SMEM_LIMIT, basic_chain_plain, bf16_chain_bytes,
    bf16_chain_plan, fused_smem, launch_plan,
)

torch.set_num_threads(2)
BRANCHES = ((32, 128), (64, 64), (128, 32), (256, 16))   # (C, H) at 512x512


def emulate_fused_chain(x, w, sc, sh, blocks, tile_h, tile_w,
                        zero_h_outside=True):
    """The fused kernel's schedule in plain torch: per block and output
    tile, conv1 (no padding) over the tile's window, the block input +- 2
    pixels with zero outside the image, gives h over the tile +- 1 pixel,
    zeroed where that pixel lies outside the image (conv2's padding, not
    conv1 evaluated there); conv2 (no padding) over h gives the tile,
    plus the window's centre as the residual. bf16 roundings where the
    kernel rounds. `zero_h_outside=False` evaluates conv1 there instead:
    the rule the kernel must not follow."""
    B, C, H, W = x.shape
    y = x.float()
    for n in range(blocks):
        w1, w2 = (w[n, j].float().reshape(3, C, 3, C).permute(3, 1, 0, 2)
                  for j in range(2))
        out = torch.empty_like(y)
        yp = F.pad(y, (2, 2 + tile_w, 2, 2 + tile_h))
        for ty0 in range(0, H, tile_h):
            for tx0 in range(0, W, tile_w):
                win = yp[:, :, ty0:ty0 + tile_h + 4, tx0:tx0 + tile_w + 4]
                h = F.conv2d(bf16_round(win), w1)
                h = torch.relu(h * sc[n, 0][:, None, None]
                               + sh[n, 0][:, None, None])
                if zero_h_outside:
                    gy = torch.arange(ty0 - 1, ty0 + tile_h + 1)
                    gx = torch.arange(tx0 - 1, tx0 + tile_w + 1)
                    inside = (((gy >= 0) & (gy < H))[:, None]
                              & ((gx >= 0) & (gx < W))[None, :])
                    h = torch.where(inside, h, torch.zeros(()))
                o = F.conv2d(bf16_round(h), w2)
                o = o * sc[n, 1][:, None, None] + sh[n, 1][:, None, None]
                o = torch.relu(o + win[:, :, 2:2 + tile_h, 2:2 + tile_w])
                hh, ww = min(tile_h, H - ty0), min(tile_w, W - tx0)
                out[:, :, ty0:ty0 + hh, tx0:tx0 + ww] = o[:, :, :hh, :ww]
        y = out
    return y.to(x.dtype)


def _operands(g, B, C, H, W, blocks):
    x = torch.randn(B, C, H, W, generator=g).bfloat16()
    w = (torch.randn(blocks, 2, 3 * C, 3 * C, generator=g) * 0.05).bfloat16()
    sc = 1 + 0.1 * torch.randn(blocks, 2, C, generator=g)
    sh = 0.1 * torch.randn(blocks, 2, C, generator=g)
    return x, w, sc, sh


@pytest.mark.parametrize("B", [1, 2, 8, 64])
@pytest.mark.parametrize("C,H", BRANCHES)
def test_bf16_chain_plan_at_branch_shapes(B, C, H):
    """C = 32 and 64 run the fused block kernel wherever the f32 chain
    sums K in one piece: one launch a block, at most one persistent CTA
    an SM, no clusters, shared memory within a Hopper block's 232,448
    bytes, 28 bytes of device memory an element of a 4-block chain. C =
    128 and 256 keep the passes (two launches a block, 62 bytes)."""
    plan = bf16_chain_plan(B, C, H, H)
    assert plan.smem <= SMEM_LIMIT and plan.cluster == 1
    assert plan.fused == (C in FUSED_TILES)
    if plan.fused:
        th, tw, warps = FUSED_TILES[C]
        tiles = B * -(-H // th) * -(-H // tw)
        assert (plan.tile_h, plan.tile_w, plan.warps) == (th, tw, warps)
        assert plan.tiles == tiles and plan.ctas == min(tiles, CARD_SMS)
        assert plan.launches_per_block == 1 and plan.passes is None
        assert plan.smem == fused_smem(C, th, tw, plan.stages)
        assert bf16_chain_bytes(plan, 4) == 28
    else:
        assert plan.passes == launch_plan(B, C, H, H)
        assert plan.launches_per_block == 2 and plan.ctas == plan.passes.ctas
        assert bf16_chain_bytes(plan, 4) == 62


def test_fused_smem_matches_the_kernel_note():
    """The plans that csrc/chain_block_bf16.cu's note gives: C = 32 at 16 x
    16 with two staging buffers, C = 64 at 8 x 8 with one (two would
    exceed a block's shared memory)."""
    assert bf16_chain_plan(64, 32, 128, 128).stages == 2
    assert fused_smem(32, 16, 16, 2) == 215_424
    assert bf16_chain_plan(64, 64, 64, 64).stages == 1
    assert fused_smem(64, 8, 8, 1) == 230_016
    assert fused_smem(64, 8, 8, 2) > SMEM_LIMIT


def test_bf16_chain_plan_keeps_passes_where_the_f32_chain_splits_k():
    """Where the f32 chain's plan splits K (its partial sums are added in
    another order), the bf16 chain takes the passes, so that it stays
    bit-equal to the f32 chain rounded."""
    for B, C, H, W in ((1, 256, 16, 16), (2, 40, 20, 33), (1, 16, 13, 7)):
        plan = bf16_chain_plan(B, C, H, W)
        assert not plan.fused and plan.passes == launch_plan(B, C, H, W)
    assert launch_plan(1, 256, 16, 16).ksplit > 1


@pytest.mark.parametrize("B,C,W,fused", [
    (2, 32, 24, True), (16, 64, 8, True), (1, 32, 8, True),
    (2, 32, 33, False), (1, 32, 3, False), (2, 64, 60, False),
    (1, 64, 23, False), (8, 64, 4, False)])
def test_bf16_chain_plan_takes_the_passes_where_tma_cannot_read(B, C, W,
                                                                fused):
    """The fused kernel reads its input by TMA, whose rows must be
    16-byte aligned: W % 8 == 0 for bf16 x. Elsewhere (a 480-pixel input
    gives W = 60 at C = 64) the plan takes the passes, which were 3-4.5x
    faster there than a copy path in the kernel."""
    plan = bf16_chain_plan(B, C, 20, W)
    assert plan.fused == fused
    if not fused:
        assert plan.passes == launch_plan(B, C, 20, W)
        assert plan.launches_per_block == 2


@pytest.mark.parametrize("B,C,H,W,blocks", [
    (2, 32, 37, 33, 2), (1, 32, 3, 3, 2), (1, 64, 3, 3, 1),
    (2, 64, 19, 23, 3), (1, 32, 20, 24, 4), (1, 64, 3, 8, 2)])
def test_fused_tile_schedule_matches_plain(B, C, H, W, blocks):
    """Ragged shapes (H and W not multiples of the tile, an image smaller
    than the halo): the emulated tile schedule at the plan's tile is
    bit-equal to `basic_chain_plain`, and the other halo rule (conv1
    evaluated outside the image) is not. The shapes with W % 8 != 0 run
    the passes on the card; they test the schedule's halo rule alone."""
    g = torch.Generator().manual_seed(B * 1000 + C + H + W)
    x, w, sc, sh = _operands(g, B, C, H, W, blocks)
    th, tw, _ = FUSED_TILES[C]
    ref = basic_chain_plain(x, w, sc, sh, blocks)
    assert torch.equal(emulate_fused_chain(x, w, sc, sh, blocks, th, tw), ref)
    wrong = emulate_fused_chain(x, w, sc, sh, blocks, th, tw,
                                zero_h_outside=False)
    assert not torch.equal(wrong, ref)
