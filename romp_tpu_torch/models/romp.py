"""ROMP network: HRNet-W32 backbone + CoordConv + three conv heads
(counterpart of `romp_tpu/models/romp.py`).

At 512x512 input the heads regress 64x64 maps: params (142 ch = 6D global
orient + 21 x 6D body pose + 10 betas), center (1 ch) and cam (3 ch). The
packed params output is [cam(3) | pose6d(132) | betas(10)] = 145 ch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from romp_tpu_torch.models.hrnet import Branch, hrnet32
from romp_tpu_torch.models.layers import (
    F32, BasicBlock, Conv2d, LayerOpts, batch_norm, he_normal_,
)

NUM_POSE_6D = 132          # 22 joints x 6D
NUM_BETAS = 10
NUM_PARAMS_MAP = NUM_POSE_6D + NUM_BETAS  # 142 (head); packed output adds cam
NUM_CAM_MAP = 3
HEAD_CHANNELS = 64
BACKBONES = ("hrnet32", "hrnet32_tiny")


def coord_maps(size: int, dtype=torch.float32,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(1, 2, size, size) CoordConv maps in [-1, 1]; channel 0 = x
    (columns), channel 1 = y (rows), as `romp.py:33-39`."""
    r = (torch.arange(size, dtype=dtype, device=device) / (size - 1)) * 2.0 - 1.0
    xx = r[None, :].expand(size, size)
    yy = r[:, None].expand(size, size)
    return torch.stack([xx, yy], dim=0)[None]


class Head(nn.ModuleList):
    """One output head (`romp.py:42-50`): stride-2 3x3 conv WITH bias, then
    BN (a reference quirk kept for checkpoint compatibility) -> 2
    BasicBlocks -> 1x1 conv with bias."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__([
            nn.ModuleList([Conv2d(in_ch, HEAD_CHANNELS, 3, 2, bias=True),
                           batch_norm(HEAD_CHANNELS)]),
            nn.ModuleList([
                nn.ModuleList([BasicBlock(HEAD_CHANNELS, HEAD_CHANNELS)])
                for _ in range(2)]),
            Conv2d(HEAD_CHANNELS, out_ch, 1, 1, padding=0, bias=True),
        ])

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        conv, bn = self[0]
        x = torch.relu(bn(conv(x, opts)))
        for (block,) in self[1]:
            x = block(x, opts)
        return self[2](x, opts)


class RompNet(nn.Module):
    """ROMP; `forward` is `romp_forward` (`romp.py:53-90`). State-dict keys
    equal the JAX package's
    flat-dict keys and the reference's (`final_layers.1` params,
    `final_layers.2` center, `final_layers.3` cam)."""

    def __init__(self, backbone: str = "hrnet32"):
        super().__init__()
        if backbone not in BACKBONES:
            raise NotImplementedError(
                f"backbone {backbone!r}: the port has {BACKBONES}")
        self.backbone = hrnet32(backbone)
        in_ch = 32 + 2
        self.final_layers = nn.ModuleList([
            nn.Identity(),     # index 0 holds no parameters, as the reference
            Head(in_ch, NUM_PARAMS_MAP),
            Head(in_ch, 1),
            Head(in_ch, NUM_CAM_MAP)])

    def pack_chains(self) -> None:
        """Pack every HRNet branch chain for the fused-chain kernel."""
        for m in self.modules():
            if isinstance(m, Branch):
                m.pack()

    def forward(self, image: torch.Tensor,
                opts: LayerOpts = F32) -> Tuple[torch.Tensor, torch.Tensor]:
        """image: (B, S, S, 3) float RGB in [0, 255] (the JAX layout).

        Returns (center_maps (B, S/8, S/8, 1), params_maps (B, S/8, S/8,
        145)), channels-last like the JAX package.
        """
        x = ((image.float() / 255.0) * 2.0 - 1.0).permute(0, 3, 1, 2)
        x = x.contiguous()   # NCHW memory: cuDNN keeps it, the kernel needs it
        feat = self.backbone(x, opts)
        cm = coord_maps(feat.shape[2], feat.dtype, feat.device)
        feat = torch.cat([feat, cm.expand(feat.shape[0], -1, -1, -1)], dim=1)
        params_maps = self.final_layers[1](feat, opts)
        center_maps = self.final_layers[2](feat, opts)
        cam_maps = self.final_layers[3](feat, opts)
        params_maps = torch.cat([cam_maps, params_maps], dim=1)
        return (center_maps.permute(0, 2, 3, 1),
                params_maps.permute(0, 2, 3, 1))


def init_romp_params(generator: torch.Generator,
                     backbone: str = "hrnet32") -> Dict[str, torch.Tensor]:
    """A fresh seeded state dict, initialized as the JAX package initializes
    (`layers.py:80-91`): conv weights He-normal over fan_in, conv biases 0,
    BN weight 1, bias 0, running mean 0, running var 1. The numbers differ
    from JAX's (another generator); the distributions do not."""
    net = RompNet(backbone)
    for m in net.modules():
        if isinstance(m, Conv2d):
            he_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return net.state_dict()


def calibrate_batchnorm(net: RompNet, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of its input on
    `images` (B, S, S, 3) RGB in [0, 255]: one train-mode pass with a
    cumulative average. Leaves the net in eval mode.

    For random weights: with untouched statistics (mean 0, var 1) the
    He-normal net's activations grow layer by layer to ~1e6 at the heads,
    where an absolute bar means nothing and the cam scale 1.1**s overflows;
    calibrated, they have the scale trained weights give."""
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.momentum = None
        m.reset_running_stats()
    with torch.no_grad():
        net.train()(images)
    for m in bns:
        m.momentum = 0.1
    net.eval()
