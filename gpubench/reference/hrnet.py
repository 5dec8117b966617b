"""HRNet-W32 (Sun et al., CVPR'19; the backbone of ROMP and BEV), plain.

Stem (two stride-2 3x3 convs), layer1 (4 Bottlenecks to 256 channels),
then stages 2-4 of parallel branches (32, 64, 128, 256 channels at 1/4 to
1/32 of the input), each module's branches 4 BasicBlocks deep and fused all
to all; the last module keeps only the 1/4 branch. `depth` gives the
modules of stages 3 and 4 and the blocks a branch: (4, 3, 4) is HRNet-W32,
(1, 1, 2) the small twin the CPU tests use.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from gpubench.reference.nn import Ctx

FULL = (4, 3, 4)
TINY = (1, 1, 2)
DEPTHS = {"hrnet32": FULL, "hrnet32_tiny": TINY}


def basic_block(c: Ctx, name: str, x: torch.Tensor, planes: int,
                stride: int = 1, downsample: bool = False) -> torch.Tensor:
    out = torch.relu(c.bn(f"{name}.bn1",
                          c.conv2d(f"{name}.conv1", x, planes, 3, stride)))
    out = c.bn(f"{name}.bn2", c.conv2d(f"{name}.conv2", out, planes, 3))
    res = x
    if downsample:
        res = c.bn(f"{name}.downsample.1",
                   c.conv2d(f"{name}.downsample.0", x, planes, 1, stride))
    return torch.relu(out + res)


def bottleneck(c: Ctx, name: str, x: torch.Tensor, planes: int,
               downsample: bool) -> torch.Tensor:
    out = torch.relu(c.bn(f"{name}.bn1",
                          c.conv2d(f"{name}.conv1", x, planes, 1)))
    out = torch.relu(c.bn(f"{name}.bn2",
                          c.conv2d(f"{name}.conv2", out, planes, 3)))
    out = c.bn(f"{name}.bn3", c.conv2d(f"{name}.conv3", out, planes * 4, 1))
    res = x
    if downsample:
        res = c.bn(f"{name}.downsample.1",
                   c.conv2d(f"{name}.downsample.0", x, planes * 4, 1))
    return torch.relu(out + res)


def hr_module(c: Ctx, name: str, xs: List[torch.Tensor],
              channels: Sequence[int], blocks: int,
              multi_scale: bool) -> List[torch.Tensor]:
    xs = list(xs)
    for i, ch in enumerate(channels):
        for b in range(blocks):
            xs[i] = basic_block(c, f"{name}.branches.{i}.{b}", xs[i], ch)
    outs = []
    for i in range(len(channels) if multi_scale else 1):
        y = None
        for j in range(len(channels)):
            f = f"{name}.fuse_layers.{i}.{j}"
            if j == i:
                t = xs[j]
            elif j > i:
                t = c.bn(f"{f}.1", c.conv2d(f"{f}.0", xs[j], channels[i], 1))
                t = F.interpolate(t, scale_factor=2 ** (j - i),
                                  mode="nearest")
            else:
                t = xs[j]
                for k in range(i - j):
                    last = k == i - j - 1
                    t = c.bn(f"{f}.{k}.1", c.conv2d(
                        f"{f}.{k}.0", t, channels[i] if last else channels[j],
                        3, 2))
                    if not last:
                        t = torch.relu(t)
            y = t if y is None else y + t
        outs.append(torch.relu(y))
    return outs


def transition(c: Ctx, name: str, ys: List[torch.Tensor],
               pre: Sequence[int], cur: Sequence[int]) -> List[torch.Tensor]:
    xs = []
    for i, ch in enumerate(cur):
        if i < len(pre):
            if ch == pre[i]:
                xs.append(ys[i])
                continue
            t = c.conv2d(f"{name}.{i}.0", ys[i], ch, 3)
            xs.append(torch.relu(c.bn(f"{name}.{i}.1", t)))
        else:
            t = c.conv2d(f"{name}.{i}.0.0", ys[-1], ch, 3, 2)
            xs.append(torch.relu(c.bn(f"{name}.{i}.0.1", t)))
    return xs


def hrnet(c: Ctx, x: torch.Tensor, depth=FULL,
          name: str = "backbone") -> torch.Tensor:
    """x (B, 3, H, W) in [-1, 1] -> (B, 32, H/4, W/4)."""
    stage3, stage4, blocks = depth
    x = torch.relu(c.bn(f"{name}.bn1", c.conv2d(f"{name}.conv1", x, 64, 3, 2)))
    x = torch.relu(c.bn(f"{name}.bn2", c.conv2d(f"{name}.conv2", x, 64, 3, 2)))
    for b in range(4):
        x = bottleneck(c, f"{name}.layer1.{b}", x, 64, b == 0)
    s2, s3, s4 = (32, 64), (32, 64, 128), (32, 64, 128, 256)
    xs = transition(c, f"{name}.transition1", [x], (256,), s2)
    xs = hr_module(c, f"{name}.stage2.0", xs, s2, blocks, True)
    xs = transition(c, f"{name}.transition2", xs, s2, s3)
    for m in range(stage3):
        xs = hr_module(c, f"{name}.stage3.{m}", xs, s3, blocks, True)
    xs = transition(c, f"{name}.transition3", xs, s3, s4)
    for m in range(stage4):
        xs = hr_module(c, f"{name}.stage4.{m}", xs, s4, blocks,
                       m != stage4 - 1)
    return xs[0]


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) RGB in [0, 255] -> (B, 3, S, S) in [-1, 1]."""
    return ((images.float() / 255.0) * 2.0 - 1.0).permute(0, 3, 1, 2
                                                          ).contiguous()
