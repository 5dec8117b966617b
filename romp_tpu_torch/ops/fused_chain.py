"""Fused chain of stride-1 HRNet BasicBlocks (inference): the hand-written
CUDA kernel and its plain twin.

Counterpart of `romp_tpu/ops/pallas_fuse.py`. Each BasicBlock is
conv3x3 -> folded BN -> ReLU -> conv3x3 -> folded BN + residual -> ReLU,
with the mixed-path numerics of the TPU kernel: conv operands rounded to
bf16, f32 accumulation, f32 BN / residual / ReLU. The kernel
(`romp_tpu_torch/csrc/basic_chain.cu`) is one conv pass; a block is two
launches.

Layouts: activations are NCHW (the port's network layout); the packed
weights keep the TPU kernel's layout, w[n, j, dy*C + ci, dx*C + co], so
they compare with `pallas_fuse.pack_chain_weights` bit for bit.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from romp_tpu_torch.models.layers import BN_EPS, bf16_round
from romp_tpu_torch.ops import _build


def pack_chain_weights(params: Mapping[str, torch.Tensor], prefix: str,
                       blocks: int) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """torch-named (OIHW) params -> (w, scale, shift) kernel operands.

    w:     (blocks, 2, 3C, 3C) bf16 — w[n, j, dy*C + ci, dx*C + co]
    scale: (blocks, 2, C) f32 — folded BN gamma / sqrt(var + eps)
    shift: (blocks, 2, C) f32 — folded BN beta - mean * scale
    """
    pre = f"{prefix}." if prefix else ""
    ws, scs, shs = [], [], []
    for n in range(blocks):
        for cname, bname in ((f"{pre}{n}.conv1", f"{pre}{n}.bn1"),
                             (f"{pre}{n}.conv2", f"{pre}{n}.bn2")):
            w = params[f"{cname}.weight"]                # (C, C, 3, 3) OIHW
            C = w.shape[0]
            ws.append(w.permute(2, 1, 3, 0).reshape(3 * C, 3 * C))
            s = params[f"{bname}.weight"] * torch.rsqrt(
                params[f"{bname}.running_var"] + BN_EPS)
            scs.append(s)
            shs.append(params[f"{bname}.bias"]
                       - params[f"{bname}.running_mean"] * s)
    C = ws[0].shape[0] // 3
    return (torch.stack(ws).reshape(blocks, 2, 3 * C, 3 * C)
            .to(torch.bfloat16).contiguous(),
            torch.stack(scs).reshape(blocks, 2, C).float().contiguous(),
            torch.stack(shs).reshape(blocks, 2, C).float().contiguous())


def conv_pass_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv pass in plain PyTorch: relu(conv3x3(bf16(x), bf16(w)) *
    scale + shift [+ residual]); x (B, C, H, W) f32, w one packed (3C, 3C)
    matrix. Exact products of bf16 operands, f32 sums."""
    C = x.shape[1]
    wk = w.float().reshape(3, C, 3, C).permute(3, 1, 0, 2)  # (dy,ci,dx,co)->OIHW
    o = F.conv2d(bf16_round(x), wk, padding=1)
    o = o * scale[:, None, None] + shift[:, None, None]
    if residual is not None:
        o = o + residual
    return torch.relu(o)


def basic_chain_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, blocks: int) -> torch.Tensor:
    """Plain PyTorch chain (twin of `reference_basic_chain`): x (B, C, H, W)
    f32 -> same shape."""
    y = x.float()
    for n in range(blocks):
        h = conv_pass_plain(y, w[n, 0], scale[n, 0], shift[n, 0])
        y = conv_pass_plain(h, w[n, 1], scale[n, 1], shift[n, 1], residual=y)
    return y


def _check_operands(x, w, scale, shift, lead=()) -> None:
    """Raise unless the operands are what the kernel reads: x (B, C, H, W)
    f32 on a CUDA device, w (*lead, 3C, 3C) bf16, scale and shift
    (*lead, C) f32, all on x's device and contiguous."""
    if x.dim() != 4 or x.device.type != "cuda":
        raise ValueError(f"basic_chain: x must be a (B, C, H, W) CUDA "
                         f"tensor, got {tuple(x.shape)} on {x.device}")
    C = x.shape[1]
    for name, t, dtype, shape in (
            ("x", x, torch.float32, x.shape),
            ("w", w, torch.bfloat16, (*lead, 3 * C, 3 * C)),
            ("scale", scale, torch.float32, (*lead, C)),
            ("shift", shift, torch.float32, (*lead, C))):
        _build.check_operand("basic_chain", name, t, dtype, shape, x.device)


def _launch(src, w, scale, shift, residual, dst) -> None:
    """One kernel launch on checked operands (w one packed (3C, 3C) matrix)."""
    B, C, H, W = src.shape
    with torch.cuda.device(src.device):
        err = _build.load().romp_conv3x3_bn_act(
            src.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            None if residual is None else residual.data_ptr(), dst.data_ptr(),
            B, C, H, W, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "romp_conv3x3_bn_act")
    conv_pass.launches += 1


def conv_pass(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              shift: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv pass of the chain: the CUDA kernel for CUDA tensors,
    `conv_pass_plain` for CPU tensors. `conv_pass.launches` counts the
    kernel's launches, here and inside `basic_chain`."""
    if x.device.type == "cpu":
        return conv_pass_plain(x, w, scale, shift, residual)
    _check_operands(x, w, scale, shift)
    if residual is not None:
        _build.check_operand("basic_chain", "residual", residual,
                             torch.float32, x.shape, x.device)
    out = torch.empty_like(x)
    if x.numel():
        _launch(x, w, scale, shift, residual, out)
    return out


def basic_chain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor, blocks: int) -> torch.Tensor:
    """Run `blocks` BasicBlocks over x (B, C, H, W) f32: the CUDA kernel
    (two launches a block) for CUDA tensors, `basic_chain_plain` for CPU
    tensors."""
    if x.device.type == "cpu":
        return basic_chain_plain(x, w, scale, shift, blocks)
    _check_operands(x, w, scale, shift, lead=(blocks, 2))
    if x.numel() == 0:
        return torch.empty_like(x)
    h = torch.empty_like(x)
    outs = (torch.empty_like(x), torch.empty_like(x))
    y = x
    for n in range(blocks):
        out = outs[n % 2]
        _launch(y, w[n, 0], scale[n, 0], shift[n, 0], None, h)
        _launch(h, w[n, 1], scale[n, 1], shift[n, 1], y, out)
        y = out
    return y


conv_pass.launches = 0
