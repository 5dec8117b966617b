"""ResNet-50 backbone with the deconv upsampling head, NCHW (counterpart of
`romp_tpu/models/resnet.py`).

ImageNet normalization inside the backbone, 7x7 stride-2 stem, 3x3
stride-2 max pool, Bottleneck stages [3, 4, 6, 3], then three 4x4 stride-2
transposed convs 2048 -> 256 -> 128 -> 64 (each with BN and ReLU): 64
channels at a quarter of the input's resolution (128x128 for 512x512).
Parameter names are the reference's (`backbone.layer1.0.conv1.weight`,
`backbone.deconv_layers.{0,3,6}.weight`, their BNs at 1, 4, 7).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from romp_tpu_torch.models.layers import (
    F32, Bottleneck, Conv2d, ConvTranspose2d, LayerOpts, at_least_f32,
    batch_norm, max_pool2d,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
DECONV_FILTERS = (256, 128, 64)
OUT_CHANNELS = DECONV_FILTERS[-1]


class ResNet50(nn.Module):
    """forward: image (B, H, W, 3) RGB in [0, 255] (the JAX layout) ->
    (B, 64, H/4, W/4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3)
        self.bn1 = batch_norm(64)
        in_ch = 64
        for si, (planes, blocks, stride) in enumerate(STAGES, start=1):
            setattr(self, f"layer{si}", nn.ModuleList([
                Bottleneck(in_ch if b == 0 else planes * 4, planes,
                           stride=stride if b == 0 else 1,
                           downsample=(b == 0))
                for b in range(blocks)]))
            in_ch = planes * 4
        deconv = []
        for planes in DECONV_FILTERS:
            # [convT, bn, relu] x 3: the reference's Sequential indices
            deconv += [ConvTranspose2d(in_ch, planes, 4, 2, 1),
                       batch_norm(planes), nn.ReLU()]
            in_ch = planes
        self.deconv_layers = nn.ModuleList(deconv)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, image: torch.Tensor,
                opts: LayerOpts = F32) -> torch.Tensor:
        x = ((at_least_f32(image) / 255.0 - self.mean) / self.std).permute(
            0, 3, 1, 2).contiguous()
        x = torch.relu(self.bn1(self.conv1(x, opts)))
        x = max_pool2d(x, 3, 2, 1)
        for si in range(1, len(STAGES) + 1):
            for block in getattr(self, f"layer{si}"):
                x = block(x, opts)
        for i in range(0, len(self.deconv_layers), 3):
            convt, bn, _ = self.deconv_layers[i:i + 3]
            x = torch.relu(bn(convt(x, opts)))
        return x
