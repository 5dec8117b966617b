"""HRNet-W32 backbone, NCHW (counterpart of `romp_tpu/models/hrnet.py`).

Same structure and parameter names as the JAX package (and the reference
torch state_dict): stem -> layer1 (4 Bottlenecks) -> stages 2-4 with branch
channels (32, 64) / (32, 64, 128) / (32, 64, 128, 256). The depth knobs
(modules per stage, blocks per branch) give the tiny twin `hrnet32_tiny`
(`hrnet.py:161-174`) that the CPU tests use.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from romp_tpu_torch.models.layers import (
    F32, BasicBlock, Bottleneck, Conv2d, LayerOpts, batch_norm,
)
from romp_tpu_torch.ops.fused_chain import basic_chain, pack_chain_weights

STAGE2_CHANNELS = (32, 64)
STAGE3_CHANNELS = (32, 64, 128)
STAGE4_CHANNELS = (32, 64, 128, 256)
BLOCKS_PER_BRANCH = 4


class Branch(nn.ModuleList):
    """A chain of stride-1 BasicBlocks (`hrnet.py:32-40`). With
    `opts.fuse_chains`, in eval mode, it runs through the fused-chain kernel
    on the weights that `pack()` packed (bf16 in and out on the
    bf16-activation path)."""

    def __init__(self, planes: int, blocks: int):
        super().__init__([BasicBlock(planes, planes) for _ in range(blocks)])
        # kernel operands: non-persistent buffers, so they follow .to(device)
        # and stay out of the state_dict
        for name in ("packed_w", "packed_scale", "packed_shift"):
            self.register_buffer(name, None, persistent=False)

    def pack(self) -> None:
        """Fold BN and pack the conv weights for the kernel, once after
        loading weights (inference)."""
        with torch.no_grad():
            self.packed_w, self.packed_scale, self.packed_shift = (
                pack_chain_weights(self.state_dict(), "", len(self)))

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        # inference only: in train mode the blocks run unfused, as the
        # reference turns fuse_chains off in training (`layers.py:55`)
        if opts.fuse_chains and not self.training:
            if self.packed_w is None:
                raise RuntimeError("fuse_chains needs packed weights: call "
                                   "RompNet.pack_chains() after loading")
            return basic_chain(x.contiguous(), self.packed_w, self.packed_scale,
                               self.packed_shift, len(self))
        for block in self:
            x = block(x, opts)
        return x


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch blocks + all-to-all fusion
    (`hrnet.py:43-77`)."""

    def __init__(self, channels: Sequence[int], multi_scale_output: bool = True,
                 blocks: int = BLOCKS_PER_BRANCH):
        super().__init__()
        nb = len(channels)
        self.branches = nn.ModuleList(
            [Branch(c, blocks) for c in channels])
        fuse = []
        for i in range(nb if multi_scale_output else 1):
            row = []
            for j in range(nb):
                if j > i:
                    row.append(nn.ModuleList([
                        Conv2d(channels[j], channels[i], 1, 1, padding=0),
                        batch_norm(channels[i])]))
                elif j == i:
                    row.append(None)
                else:
                    steps = []
                    for k in range(i - j):
                        out_ch = channels[i] if k == i - j - 1 else channels[j]
                        steps.append(nn.ModuleList([
                            Conv2d(channels[j], out_ch, 3, 2),
                            batch_norm(out_ch)]))
                    row.append(nn.ModuleList(steps))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor],
                opts: LayerOpts = F32) -> List[torch.Tensor]:
        xs = [branch(x, opts) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = layer[1](layer[0](xs[j], opts))
                    t = upsample_nearest(t, 2 ** (j - i))
                else:
                    t = xs[j]
                    for k, (conv, bn) in enumerate(layer):
                        t = bn(conv(t, opts))
                        if k != len(layer) - 1:
                            t = torch.relu(t)
                y = t if y is None else y + t
            outs.append(torch.relu(y))
        return outs


class Transition(nn.ModuleList):
    """Stage transition (`hrnet.py:80-102`): keep or convert each existing
    branch, grow a new one from the coarsest by a stride-2 3x3 conv."""

    def __init__(self, pre_channels: Sequence[int],
                 cur_channels: Sequence[int]):
        layers = []
        for i, ch in enumerate(cur_channels):
            if i < len(pre_channels):
                layers.append(None if ch == pre_channels[i] else nn.ModuleList(
                    [Conv2d(pre_channels[i], ch, 3, 1), batch_norm(ch)]))
            else:
                layers.append(nn.ModuleList([nn.ModuleList(
                    [Conv2d(pre_channels[-1], ch, 3, 2), batch_norm(ch)])]))
        super().__init__(layers)
        self.n_pre = len(pre_channels)

    def forward(self, ys: List[torch.Tensor],
                opts: LayerOpts = F32) -> List[torch.Tensor]:
        xs = []
        for i, layer in enumerate(self):
            if layer is None:
                xs.append(ys[i])
                continue
            if i < self.n_pre:          # convert an existing branch
                (conv, bn), src = layer, ys[i]
            else:                       # grow a new one from the coarsest
                (conv, bn), src = layer[0], ys[-1]
            xs.append(torch.relu(bn(conv(src, opts))))
        return xs


class HRNet(nn.Module):
    """HRNet-W32. forward: x (B, 3, H, W) normalized to [-1, 1] ->
    the full-resolution map (B, 32, H/4, W/4)."""

    def __init__(self, stage3_modules: int = 4, stage4_modules: int = 3,
                 blocks: int = BLOCKS_PER_BRANCH):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 3, 2)
        self.bn1 = batch_norm(64)
        self.conv2 = Conv2d(64, 64, 3, 2)
        self.bn2 = batch_norm(64)
        self.layer1 = nn.ModuleList(
            [Bottleneck(64 if b == 0 else 256, 64, downsample=(b == 0))
             for b in range(4)])
        self.transition1 = Transition((256,), STAGE2_CHANNELS)
        self.stage2 = nn.ModuleList(
            [HRModule(STAGE2_CHANNELS, blocks=blocks)])
        self.transition2 = Transition(STAGE2_CHANNELS, STAGE3_CHANNELS)
        self.stage3 = nn.ModuleList(
            [HRModule(STAGE3_CHANNELS, blocks=blocks)
             for _ in range(stage3_modules)])
        self.transition3 = Transition(STAGE3_CHANNELS, STAGE4_CHANNELS)
        self.stage4 = nn.ModuleList(
            [HRModule(STAGE4_CHANNELS, multi_scale_output=(m != stage4_modules - 1),
                      blocks=blocks)
             for m in range(stage4_modules)])

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x, opts)))
        x = torch.relu(self.bn2(self.conv2(x, opts)))
        for block in self.layer1:
            x = block(x, opts)
        xs = self.transition1([x], opts)
        for stage, transition in ((self.stage2, None),
                                  (self.stage3, self.transition2),
                                  (self.stage4, self.transition3)):
            if transition is not None:
                xs = transition(xs, opts)
            for module in stage:
                xs = module(xs, opts)
        return xs[0]


def hrnet32(backbone: str = "hrnet32") -> HRNet:
    """The full HRNet-W32, or its depth-reduced twin `hrnet32_tiny`
    (1 module in stages 3/4, 2 blocks per branch; not checkpoint-compatible
    with released weights)."""
    if backbone == "hrnet32":
        return HRNet()
    if backbone == "hrnet32_tiny":
        return HRNet(stage3_modules=1, stage4_modules=1, blocks=2)
    raise ValueError(f"unknown HRNet backbone {backbone!r}")
