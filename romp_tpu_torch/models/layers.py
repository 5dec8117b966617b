"""Layer modules of the port (2D inference subset of `romp_tpu/models/layers.py`).

Module names follow the reference torch state_dict, which is also the JAX
package's flat-dict naming (`layers.py:180-209`): a released checkpoint loads
with `load_state_dict(strict=True)`. Activations are NCHW.

Precision follows the JAX package's `compute_dtype` / `act_dtype` rule. With
compute_dtype=float32 a conv is a plain f32 conv. With bfloat16 (the mixed
path) JAX feeds the conv bf16 inputs and bf16 weights and returns f32
(`preferred_element_type`, `layers.py:125-130`): exact products, f32 sums.
`torch.conv2d` in bf16 would return bf16, a different function. The port
rounds both operands to bf16 and runs the f32 conv. On the card the caller
lets cuDNN use TF32 on the mixed path only: a bf16 value is exact in TF32,
so the products stay exact; the f32 path runs with TF32 off (see
`romp_tpu_torch.pipeline.romp_pipeline.precision_flags`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class LayerOpts:
    """What the JAX package's ParamStore carries into every layer call."""

    compute_dtype: torch.dtype = torch.float32   # conv operand dtype
    fuse_chains: bool = False    # HRNet branch chains through the kernel


F32 = LayerOpts()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 value (ties to even), keep float32."""
    return x.to(torch.bfloat16).float()


class Conv2d(nn.Conv2d):
    """nn.Conv2d with torch's explicit symmetric padding, (kernel - 1) // 2
    by default (`layers.py:102-108`), under the compute_dtype rule."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride,
                         (kernel - 1) // 2 if padding is None else padding,
                         bias=bias)

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        w = self.weight
        if opts.compute_dtype == torch.bfloat16:
            x, w = bf16_round(x), bf16_round(w)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


def batch_norm(in_ch: int) -> nn.BatchNorm2d:
    """BatchNorm2d with the JAX package's eps; inference uses running stats
    (the port runs its network in eval mode)."""
    return nn.BatchNorm2d(in_ch, eps=BN_EPS)


class BasicBlock(nn.Module):
    """ResNet BasicBlock (`layers.py:180-192`)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1)
        self.bn2 = batch_norm(planes)
        self.downsample = (nn.ModuleList([
            Conv2d(in_ch, planes, 1, stride, padding=0), batch_norm(planes)])
            if downsample else None)

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x, opts)))
        out = self.bn2(self.conv2(out, opts))
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x, opts))
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """ResNet Bottleneck, expansion 4 (`layers.py:195-209`)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 1, 1, padding=0)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, 1, padding=0)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = (nn.ModuleList([
            Conv2d(in_ch, planes * 4, 1, stride, padding=0),
            batch_norm(planes * 4)]) if downsample else None)

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x, opts)))
        out = torch.relu(self.bn2(self.conv2(out, opts)))
        out = self.bn3(self.conv3(out, opts))
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x, opts))
        return torch.relu(out + residual)


def he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """In place: N(0, 2 / fan_in) with fan_in = in_ch * kh * kw, the JAX
    package's `_he_normal` on the same shape."""
    fan_in = max(weight[0].numel(), 1)
    with torch.no_grad():
        weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
