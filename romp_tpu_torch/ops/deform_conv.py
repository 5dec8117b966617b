"""Deformable convolution (v1): the hand-written CUDA kernel and its plain twin.

Counterpart of `romp_tpu/ops/pallas_deform.py::deform_conv2d_pallas` and
`romp_tpu/ops/deform_conv.py::deform_conv2d`, in the reference torch / mmcv
layout, which is the port's NCHW:

    x (B, C, H, W); offsets (B, G*2*9, H, W) with channel
    (g*9 + k)*2 + {0: dy, 1: dx} and tap k = ky*3 + kx; weight (Cout, C, 3, 3)
    out[b, co, p] = sum_{g, k, c} weight[co, g*Cg + c, k]
                    * bilinear(x[b, g*Cg + c], p + tap_k - padding + offset)

Stride 1, dilation 1, no mask, no bias; bilinear sampling with zero outside
the image, each of the four corners checked on its own. The kernel is
`romp_tpu_torch/csrc/deform_conv.cu`. Forward only: the backward comes with
the training slice.
"""
from __future__ import annotations

import torch

from romp_tpu_torch.ops import _build

TAPS = 9


def deform_conv2d_plain(x: torch.Tensor, offsets: torch.Tensor,
                        weight: torch.Tensor, deform_groups: int = 8,
                        padding: int = 1) -> torch.Tensor:
    """Plain PyTorch deformable conv: gather-based bilinear sampling (the
    semantics of `romp_tpu/ops/deform_conv.py:21-40` bilinear_sample), then
    one contraction over (tap, channel). Shapes as the module docstring."""
    B, C, H, W = x.shape
    G = deform_groups
    Cg = C // G
    Cout = weight.shape[0]
    off = offsets.reshape(B, G, TAPS, 2, H, W).float()
    k = torch.arange(TAPS, device=x.device)
    ky = (k // 3 - padding).float().view(1, 1, TAPS, 1, 1)
    kx = (k % 3 - padding).float().view(1, 1, TAPS, 1, 1)
    yy = torch.arange(H, dtype=torch.float32, device=x.device).view(
        1, 1, 1, H, 1)
    xx = torch.arange(W, dtype=torch.float32, device=x.device).view(
        1, 1, 1, 1, W)
    ys = yy + ky + off[:, :, :, 0]                       # (B, G, 9, H, W)
    xs = xx + kx + off[:, :, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    xg = x.reshape(B, G, Cg, H * W)

    def tap(yi, xi, wt):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        idx = (yc * W + xc).reshape(B, G, 1, TAPS * H * W)
        v = torch.gather(xg, 3, idx.expand(B, G, Cg, TAPS * H * W))
        return v * (wt * valid).reshape(B, G, 1, TAPS * H * W)

    samp = (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
            + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))
    samp = samp.reshape(B, G, Cg, TAPS, H * W)
    wk = weight.reshape(Cout, G, Cg, TAPS).float()
    out = torch.einsum("bgckp,ogck->bop", samp, wk)
    return out.reshape(B, Cout, H, W)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, deform_groups: int = 8,
                  padding: int = 1) -> torch.Tensor:
    """Deformable conv: the CUDA kernel for CUDA tensors,
    `deform_conv2d_plain` for CPU tensors. All operands f32; see the module
    docstring for shapes. `deform_conv2d.launches` counts kernel launches.
    """
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, weight, deform_groups, padding)
    if x.dim() != 4 or x.device.type != "cuda":
        raise ValueError(f"deform_conv2d: x must be a (B, C, H, W) CUDA "
                         f"tensor, got {tuple(x.shape)} on {x.device}")
    B, C, H, W = x.shape
    G = deform_groups
    Cout = weight.shape[0]
    if C % G:
        raise ValueError(f"deform_conv2d: C={C} not divisible by G={G}")
    for name, t, shape in (("x", x, (B, C, H, W)),
                           ("offsets", offsets, (B, G * 2 * TAPS, H, W)),
                           ("weight", weight, (Cout, C, 3, 3))):
        _build.check_operand("deform_conv2d", name, t, torch.float32, shape,
                             x.device)
    out = torch.empty((B, Cout, H, W), dtype=torch.float32, device=x.device)
    if B == 0 or H * W == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.romp_deform_conv2d_f32(
            x.data_ptr(), offsets.data_ptr(), weight.data_ptr(),
            out.data_ptr(), B, C, H, W, G, Cout, padding,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "romp_deform_conv2d_f32")
    deform_conv2d.launches += 1
    return out


deform_conv2d.launches = 0
