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
`romp_tpu_torch/csrc/deform_conv.cu`: samples gathered into shared memory,
contracted on the tensor cores in split TF32 (`ops/lbs.py` `tf32_round` and
`split_tf32_matmul` model that arithmetic). Forward only: the backward
comes with the training slice, and the kernel wrapper raises under grad
mode when an operand requires grad.

bf16 x and weight (TRACE's bf16-activation path; offsets stay f32, the
output is f32) take the kernel's bf16 variant and `deform_conv2d_plain`'s
bf16 branch. Both round where JAX's `deform_conv2d` does on bf16 operands
(`romp_tpu/ops/deform_conv.py:89-115`): the fractions and 1 - f to bf16,
the blend of the two rows at each corner column to bf16, the blend of the
two columns (the sample) to bf16; the weight product sums in f32.
"""
from __future__ import annotations

import torch

from romp_tpu_torch.models.layers import bf16_round
from romp_tpu_torch.ops import _build

TAPS = 9
# csrc/deform_conv.cu: K columns a chunk, output channels a CTA, float4 B
# fragments a chunk
CHUNK_COLS = 32
N_TILE = 32
FRAGS = 4 * 4 * 32


def deform_smem(G: int, Cg: int) -> int:
    """csrc/deform_conv.cu `smem_bytes`: three chunks of weight fragments,
    two of samples (128 pixels x CHUNK_COLS f32) and two of the offset
    planes of the groups a chunk touches (at most G)."""
    ngc = min(G, (CHUNK_COLS - 1) // Cg + 2)
    return 3 * FRAGS * 16 + (2 * 128 * CHUNK_COLS + 2 * 2 * ngc * 128) * 4


def deform_smem_bf16(G: int, Cg: int) -> int:
    """csrc/deform_conv.cu `smem_bytes_bf16`: three chunks of bf16 B
    fragments (256 x 8 bytes), two of bf16 samples (128 pixels x 40) and
    two of the offset planes."""
    ngc = min(G, (CHUNK_COLS - 1) // Cg + 2)
    return 3 * 256 * 8 + 2 * 128 * (CHUNK_COLS + 8) * 2 + 2 * 2 * ngc * 128 * 4


def scratch_bytes_bf16(B: int, C: int, H: int, W: int, Cout: int) -> int:
    """The bf16 variant's scratch: its weight fragments, then x regrouped
    as (B, G, H*W, C/G) bf16."""
    return (-(-Cout // N_TILE) * TAPS * -(-C // CHUNK_COLS) * 256 * 8
            + 2 * B * C * H * W)


def scratch_floats(B: int, C: int, H: int, W: int, Cout: int) -> int:
    """The kernel's scratch: the split weight fragments of every
    output-channel tile and chunk, then x regrouped as (B, G, H*W, C/G)."""
    return (-(-Cout // N_TILE) * TAPS * -(-C // CHUNK_COLS) * FRAGS * 4
            + B * C * H * W)


def _sample_coords(offsets: torch.Tensor, G: int, H: int, W: int,
                   padding: int):
    """The f32 sample coordinates (ys, xs), each (B, G, 9, H, W): pixel +
    tap - padding + the tap's (dy, dx) offset."""
    B = offsets.shape[0]
    off = offsets.reshape(B, G, TAPS, 2, H, W).float()
    k = torch.arange(TAPS, device=offsets.device)
    ky = (k // 3 - padding).float().view(1, 1, TAPS, 1, 1)
    kx = (k % 3 - padding).float().view(1, 1, TAPS, 1, 1)
    yy = torch.arange(H, dtype=torch.float32, device=offsets.device).view(
        1, 1, 1, H, 1)
    xx = torch.arange(W, dtype=torch.float32, device=offsets.device).view(
        1, 1, 1, 1, W)
    return yy + ky + off[:, :, :, 0], xx + kx + off[:, :, :, 1]


def deform_conv2d_plain(x: torch.Tensor, offsets: torch.Tensor,
                        weight: torch.Tensor, deform_groups: int = 8,
                        padding: int = 1) -> torch.Tensor:
    """Plain PyTorch deformable conv: gather-based bilinear sampling (the
    semantics of `romp_tpu/ops/deform_conv.py:21-40` bilinear_sample), then
    one contraction over (tap, channel). Shapes as the module docstring.
    bf16 x and weight: JAX's bf16 rounding points (module docstring), f32
    output."""
    if x.dtype == torch.bfloat16:
        return _deform_plain_bf16(x, offsets, weight, deform_groups, padding)
    B, C, H, W = x.shape
    G = deform_groups
    Cg = C // G
    Cout = weight.shape[0]
    ys, xs = _sample_coords(offsets, G, H, W, padding)
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


def _deform_plain_bf16(x: torch.Tensor, offsets: torch.Tensor,
                       weight: torch.Tensor, deform_groups: int,
                       padding: int) -> torch.Tensor:
    """deform_conv2d_plain on bf16 x and weight, f32 offsets."""
    if weight.dtype != torch.bfloat16:
        raise ValueError(f"deform_conv2d: bf16 x needs a bf16 weight, got "
                         f"{weight.dtype}")
    B, C, H, W = x.shape
    G = deform_groups
    Cg = C // G
    Cout = weight.shape[0]
    ys, xs = _sample_coords(offsets, G, H, W, padding)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = bf16_round(ys - y0), bf16_round(xs - x0)
    wy0, wx0 = bf16_round(1.0 - fy), bf16_round(1.0 - fx)
    xg = x.float().reshape(B, G, Cg, H * W)
    n = TAPS * H * W

    def corner(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        idx = (yc * W + xc).reshape(B, G, 1, n)
        v = torch.gather(xg, 3, idx.expand(B, G, Cg, n))
        return v * valid.reshape(B, G, 1, n)

    def per(t):
        return t.reshape(B, G, 1, n)

    # rows blended at each corner column, then the columns; each rounded
    rows0 = bf16_round(per(wy0) * corner(y0, x0)
                       + per(fy) * corner(y0 + 1, x0))
    rows1 = bf16_round(per(wy0) * corner(y0, x0 + 1)
                       + per(fy) * corner(y0 + 1, x0 + 1))
    samp = bf16_round(per(wx0) * rows0 + per(fx) * rows1)
    samp = samp.reshape(B, G, Cg, TAPS, H * W)
    wk = weight.reshape(Cout, G, Cg, TAPS).float()
    out = torch.einsum("bgckp,ogck->bop", samp, wk)
    return out.reshape(B, Cout, H, W)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, deform_groups: int = 8,
                  padding: int = 1) -> torch.Tensor:
    """Deformable conv: the CUDA kernel for CUDA tensors,
    `deform_conv2d_plain` for CPU tensors. x and weight f32 (the f32
    kernel) or both bf16 (its bf16 variant); offsets f32; the output f32.
    See the module docstring for shapes. `deform_conv2d.launches` counts
    kernel launches, `deform_conv2d.bf16_launches` the bf16 variant's.
    """
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, weight, deform_groups, padding)
    if x.dim() != 4 or x.device.type != "cuda":
        raise ValueError(f"deform_conv2d: x must be a (B, C, H, W) CUDA "
                         f"tensor, got {tuple(x.shape)} on {x.device}")
    _build.check_no_grad("deform_conv2d", x, offsets, weight)
    B, C, H, W = x.shape
    G = deform_groups
    Cout = weight.shape[0]
    if C % G:
        raise ValueError(f"deform_conv2d: C={C} not divisible by G={G}")
    bf16 = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    for name, t, dt, shape in (
            ("x", x, dtype, (B, C, H, W)),
            ("offsets", offsets, torch.float32, (B, G * 2 * TAPS, H, W)),
            ("weight", weight, dtype, (Cout, C, 3, 3))):
        _build.check_operand("deform_conv2d", name, t, dt, shape, x.device)
    out = torch.empty((B, Cout, H, W), dtype=torch.float32, device=x.device)
    if B == 0 or H * W == 0:
        return out
    if bf16:
        scratch = torch.empty(scratch_bytes_bf16(B, C, H, W, Cout),
                              dtype=torch.uint8, device=x.device)
        entry = "romp_deform_conv2d_bf16"
    else:
        scratch = torch.empty(scratch_floats(B, C, H, W, Cout),
                              dtype=torch.float32, device=x.device)
        entry = "romp_deform_conv2d_f32"
    with torch.cuda.device(x.device):
        err = getattr(_build.load(), entry)(
            x.data_ptr(), offsets.data_ptr(), weight.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), B, C, H, W, G, Cout, padding,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    deform_conv2d.launches += 1
    deform_conv2d.bf16_launches += bf16
    return out


deform_conv2d.launches = 0
deform_conv2d.bf16_launches = 0
