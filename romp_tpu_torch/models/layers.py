"""Layer modules of the port (counterpart of `romp_tpu/models/layers.py`).

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

The JAX `conv1d` and `conv3d` (`layers.py:221-225, 241-245`) and the z-band
conv3d of `basic_block_3d` (`:301-305`) have no `preferred_element_type`:
on the mixed path their output is rounded to bf16 before it is cast back to
f32, and a bias is added afterwards in f32. `Conv1d` / `Conv3d` reproduce
that: bf16-rounded operands, the f32 conv, the output rounded to bf16, then
the bias.

With act_dtype=bfloat16 (JAX's low-memory inference mode, `layers.py:
118-133, 164-168, 188-192, 221-227, 241-247`) activations are bf16 between
layers and each step keeps JAX's dtype:
- Conv2d: a native bf16 conv (f32 sums, one rounding to bf16) on bf16
  weights, then a bias in bf16 (a second rounding);
- Conv1d / Conv3d: the bf16 conv; a bias is f32, so `y + bias` promotes
  the output to f32, as in JAX;
- BatchNorm: scale and shift folded in f32, cast to bf16, applied in bf16;
- residual adds and ReLUs in the operands' dtype (bf16 + f32 promotes).
The bf16 weights, biases and folded BN are cast once, by `cast_bf16(net)`
after loading (a layer raises without them). JAX refuses a bf16 activation
with f32 conv operands (`preferred_element_type` narrower than the input),
and so does `LayerOpts`.

Train mode (`net.train()`, the trainer's, `layers.py:110-120, 137-175`):
- Conv2d on the mixed path rounds its output to bf16 too, as JAX's
  train-mode conv emits the compute dtype and then upcasts (its inference
  conv emits f32); the bias is added after, in f32;
- BatchNorm takes its batch statistics in f32 as E[x^2] - E[x]^2,
  normalizes with that (biased) variance, and records the momentum-0.1
  running statistics (the unbiased variance) in the dict that
  `record_bn_updates(net)` attached, never in place: the train step
  commits them only when the gradients are finite. A recomputed forward
  (`torch.utils.checkpoint`) finds its entries taken and records nothing.
  Without an attached dict a train-mode BatchNorm is torch's, which
  updates in place (the `calibrate_*batchnorm` helpers use that).
bf16 activations are an inference mode: a bf16 BatchNorm raises in train
mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # torch's convention: new = (1 - m) * old + m * batch


@dataclasses.dataclass(frozen=True)
class LayerOpts:
    """What the JAX package's ParamStore carries into every layer call."""

    compute_dtype: torch.dtype = torch.float32   # conv operand dtype
    fuse_chains: bool = False    # HRNet branch chains through the kernel
    act_dtype: torch.dtype = torch.float32       # activations between layers

    def __post_init__(self):
        if self.act_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"act_dtype {self.act_dtype}")
        if (self.act_dtype == torch.bfloat16
                and self.compute_dtype != torch.bfloat16):
            raise ValueError("act_dtype bfloat16 needs compute_dtype "
                             "bfloat16 (JAX's conv refuses a bf16 result of "
                             "f32 operands)")

    @property
    def bf16_act(self) -> bool:
        return self.act_dtype == torch.bfloat16


F32 = LayerOpts()


def opts_from_names(compute_dtype: str, act_dtype: str = "float32",
                    fuse_chains: bool = False) -> LayerOpts:
    """LayerOpts from a pipeline config's dtype names."""
    def dtype(name):
        return torch.bfloat16 if name == "bfloat16" else torch.float32
    return LayerOpts(compute_dtype=dtype(compute_dtype),
                     fuse_chains=fuse_chains, act_dtype=dtype(act_dtype))


class _Bf16Cast:
    """The bf16 copies a layer reads on the bf16-activation path, made once
    by `cast_bf16` and kept as non-persistent buffers (they follow
    `.to(device)` and stay out of the state dict)."""

    def _bf16(self, name: str) -> torch.Tensor:
        t = getattr(self, f"{name}_bf16", None)
        if t is None:
            raise RuntimeError(
                f"{type(self).__name__}: the bf16-activation path needs its "
                "bf16 weights; call layers.cast_bf16(net) after loading")
        return t

    def _set_bf16(self, **tensors: torch.Tensor) -> None:
        for name, t in tensors.items():
            self.register_buffer(f"{name}_bf16", t, persistent=False)


def cast_bf16(net: nn.Module) -> nn.Module:
    """Cast every conv weight and bias, and every BatchNorm's folded scale
    and shift, to bf16 once (after loading weights or calibrating BN), for
    the bf16-activation path. Returns net."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, _Bf16Cast):
                m.cast_bf16()
    return net


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x as f32, or as f64 if it is f64 (an f64 net: the reference for the
    f32 path's own error)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 value (ties to even), keep float32."""
    return x.to(torch.bfloat16).float()


class Conv2d(_Bf16Cast, nn.Conv2d):
    """nn.Conv2d with torch's explicit symmetric padding, (kernel - 1) // 2
    by default (`layers.py:102-108`), under the compute_dtype rule."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride,
                         (kernel - 1) // 2 if padding is None else padding,
                         bias=bias)

    def cast_bf16(self) -> None:
        self._set_bf16(weight=self.weight.to(torch.bfloat16),
                       bias=None if self.bias is None
                       else self.bias.to(torch.bfloat16))

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        if opts.bf16_act:
            y = F.conv2d(x.to(torch.bfloat16), self._bf16("weight"), None,
                         self.stride, self.padding)
            if self.bias is not None:
                y = y + self._bf16("bias").view(-1, 1, 1)
            return y
        w = self.weight
        if opts.compute_dtype != torch.bfloat16:
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        x, w = bf16_round(x), bf16_round(w)
        if not self.training:
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        y = bf16_round(F.conv2d(x, w, None, self.stride, self.padding))
        return y if self.bias is None else y + self.bias.view(-1, 1, 1)


class ConvTranspose2d(_Bf16Cast, nn.ConvTranspose2d):
    """Transposed conv, no bias (`layers.py:334-354`): torch's weight layout
    (I, O, kh, kw), which the JAX package stores as HWOI. JAX's
    conv_transpose has no `preferred_element_type`, so on the mixed path
    its output is rounded to bf16 (inference and training alike); with bf16
    activations it is the bf16 transposed conv's."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 4,
                 stride: int = 2, torch_padding: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, torch_padding,
                         bias=False)

    def cast_bf16(self) -> None:
        self._set_bf16(weight=self.weight.to(torch.bfloat16))

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        if opts.bf16_act:
            return F.conv_transpose2d(x.to(torch.bfloat16),
                                      self._bf16("weight"), None,
                                      self.stride, self.padding)
        if opts.compute_dtype != torch.bfloat16:
            return F.conv_transpose2d(x, self.weight, None, self.stride,
                                      self.padding)
        return bf16_round(F.conv_transpose2d(
            bf16_round(x), bf16_round(self.weight), None, self.stride,
            self.padding))


def max_pool2d(x: torch.Tensor, window: int, stride: int,
               padding: int) -> torch.Tensor:
    """Strided max pool with -inf padding (`layers.py:357-365`)."""
    return F.max_pool2d(x, window, stride, padding)


class _RoundedConv(_Bf16Cast):
    """forward of Conv1d / Conv3d under the compute_dtype rule (see the
    module docstring): on the mixed path the output is rounded to bf16;
    on the bf16-activation path it is the bf16 conv's, and a bias (f32)
    promotes it to f32."""

    def cast_bf16(self) -> None:
        self._set_bf16(weight=self.weight.to(torch.bfloat16))

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        if opts.bf16_act:
            y = self._conv_forward(x.to(torch.bfloat16), self._bf16("weight"),
                                   None)
            return y if self.bias is None else y + self.bias.view(
                -1, *(1,) * (y.dim() - 2))
        if opts.compute_dtype != torch.bfloat16:
            return self._conv_forward(x, self.weight, self.bias)
        y = bf16_round(self._conv_forward(bf16_round(x),
                                          bf16_round(self.weight), None))
        return y if self.bias is None else y + self.bias.view(
            -1, *(1,) * (y.dim() - 2))


class Conv1d(_RoundedConv, nn.Conv1d):
    """nn.Conv1d over (B, C, W), symmetric padding (kernel - 1) // 2."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                         bias=bias)


class Conv3d(_RoundedConv, nn.Conv3d):
    """nn.Conv3d over (B, C, D, H, W), symmetric padding (kernel - 1) // 2."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                         bias=bias)


class _FoldedBf16Norm(_Bf16Cast):
    """forward of the BatchNorms: torch's on f32 input; on bf16 input (the
    bf16-activation path, eval mode only) x * scale + shift in bf16, with
    scale = weight / sqrt(var + eps) and shift = bias - mean * scale
    folded in f32 and cast to bf16 by `cast_bf16` (`layers.py:163-168`)."""

    def cast_bf16(self) -> None:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        self._set_bf16(scale=inv.to(torch.bfloat16),
                       shift=(self.bias - self.running_mean * inv).to(
                           torch.bfloat16))

    # set by `record_bn_updates`: (the step's dict, this module's name)
    bn_updates = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            if self.training and self.bn_updates is not None:
                return self._train_forward(x)
            return super().forward(x)
        if self.training:
            raise RuntimeError(
                "bf16 activations are an inference mode: train-mode "
                "BatchNorm takes f32 (training with bf16 activations is "
                "ROADMAP queue 1 item 5, after BEV training)")
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * self._bf16("scale").view(shape)
                + self._bf16("shift").view(shape))

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's train-mode batch_norm (`layers.py:137-175`): statistics and
        output in f32 (in f64 for an f64 net)."""
        updates, name = self.bn_updates
        axes = [0, *range(2, x.dim())]
        x32 = at_least_f32(x)
        mean = x32.mean(axes)
        var = (x32 * x32).mean(axes) - mean * mean    # biased
        key = f"{name}.running_mean"
        if key not in updates:   # a recomputed forward records nothing
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                unbiased = var * (n / max(n - 1, 1))
                updates[key] = ((1 - BN_MOMENTUM) * self.running_mean
                                + BN_MOMENTUM * mean)
                updates[f"{name}.running_var"] = (
                    (1 - BN_MOMENTUM) * self.running_var
                    + BN_MOMENTUM * unbiased)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean.view(shape)) * inv.view(shape) + self.bias.view(
            shape)


def record_bn_updates(net: nn.Module, on: bool = True,
                      into: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Make every BatchNorm of `net` record its train-mode running-statistics
    update, keyed by state-dict name, into the returned dict (`into`, or a
    fresh one) instead of updating in place; `on=False` detaches them again
    (torch's own train-mode BatchNorm)."""
    updates: Dict[str, torch.Tensor] = {} if into is None else into
    for name, m in net.named_modules():
        if isinstance(m, _FoldedBf16Norm):
            m.bn_updates = (updates, name) if on else None
    return updates


class BatchNorm1d(_FoldedBf16Norm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FoldedBf16Norm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FoldedBf16Norm, nn.BatchNorm3d):
    pass


def batch_norm(in_ch: int) -> nn.BatchNorm2d:
    """BatchNorm2d with the JAX package's eps; inference uses running stats
    (the port runs its network in eval mode)."""
    return BatchNorm2d(in_ch, eps=BN_EPS)


def batch_norm1d(in_ch: int) -> nn.BatchNorm1d:
    return BatchNorm1d(in_ch, eps=BN_EPS)


def batch_norm3d(in_ch: int) -> nn.BatchNorm3d:
    return BatchNorm3d(in_ch, eps=BN_EPS)


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


class BasicBlockConvDs(nn.Module):
    """BasicBlock whose downsample is a bare 1x1 conv WITH bias and no BN,
    the BEV / TRACE head variant (`layers.py:248-260`)."""

    def __init__(self, in_ch: int, planes: int):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1)
        self.bn2 = batch_norm(planes)
        self.downsample = Conv2d(in_ch, planes, 1, 1, padding=0, bias=True)

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x, opts)))
        out = self.bn2(self.conv2(out, opts))
        return torch.relu(out + self.downsample(x, opts))


class BasicBlock1d(nn.Module):
    """BEV BasicBlock_1D over (B, C, W): conv-bn-relu-conv-bn-relu, no
    residual (`layers.py:263-270`)."""

    def __init__(self, in_ch: int, planes: int):
        super().__init__()
        self.conv1 = Conv1d(in_ch, planes, 3)
        self.bn1 = batch_norm1d(planes)
        self.conv2 = Conv1d(planes, planes, 3)
        self.bn2 = batch_norm1d(planes)

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x, opts)))
        return torch.relu(self.bn2(self.conv2(out, opts)))


class BasicBlock3d(nn.Module):
    """BEV BasicBlock_3D over (B, C, D, H, W): conv-bn-relu-conv-bn plus the
    residual cast to the activation dtype, no final relu (`layers.py:308-
    331`). A plain Conv3d: the JAX package's z-band recast (`_conv2d_zband`)
    is a TPU layout device that computes the same function."""

    def __init__(self, in_ch: int, planes: int):
        super().__init__()
        self.conv1 = Conv3d(in_ch, planes, 3)
        self.bn1 = batch_norm3d(planes)
        self.conv2 = Conv3d(planes, planes, 3)
        self.bn2 = batch_norm3d(planes)

    def forward(self, x: torch.Tensor, opts: LayerOpts = F32) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x, opts)))
        # the residual in bf16 on the bf16-activation path; otherwise as it
        # comes (an f64 net's stays f64)
        res = x.to(torch.bfloat16) if opts.bf16_act else x
        return self.bn2(self.conv2(out, opts)) + res


def he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """In place: N(0, 2 / fan_in) with fan_in = in_ch * kh * kw, the JAX
    package's `_he_normal` on the same shape."""
    fan_in = max(weight[0].numel(), 1)
    with torch.no_grad():
        weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
