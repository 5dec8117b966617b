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
`split_tf32_matmul` model that arithmetic).

`deform_conv2d` is differentiable on f32 operands (`_DeformConv2d`, the
counterpart of the `custom_vjp` `romp_tpu/ops/pallas_deform.py:154-186`,
whose backward is the VJP of the XLA `deform_conv2d`). With S the bilinear
sample, gcol[b, g*Cg+c, k, p] = sum_o weight[o, g*Cg+c, k] * gout[b, o, p]:

    dx[b, g*Cg+c, corner]   += w_corner * valid * gcol      (a scatter)
    doffsets[b, g, k, dy|dx, p] = sum_c gcol * dS/dy | dS/dx
    dweight[o, g*Cg+c, k]   = sum_{b, p} gout[b, o, p] * S[b, g, c, k, p]

dS/dy is the row difference of the corner values blended by the x weights,
dS/dx the other way round, and floor has no gradient (as in JAX's one-hot
formulation). On CUDA tensors the backward is `csrc/deform_conv.cu`
`romp_deform_conv2d_bwd_f32` (`deform_conv2d_backward`: one pass, both
contractions in split TF32 on the tensor cores, dx summed in
shared-memory windows around each tile), on CPU tensors
`deform_conv2d_bwd_plain`, its twin.

bf16 x and weight (TRACE's bf16-activation path; offsets stay f32, the
output is f32) take the kernel's bf16 variant and `deform_conv2d_plain`'s
bf16 branch. Both round where JAX's `deform_conv2d` does on bf16 operands
(`romp_tpu/ops/deform_conv.py:89-115`): the fractions and 1 - f to bf16,
the blend of the two rows at each corner column to bf16, the blend of the
two columns (the sample) to bf16; the weight product sums in f32. The
bf16 variant is one launch of persistent CTAs (`deform_bf16_plan`) that a
producer warp feeds with the offsets and a window of x around each pixel
tile; samples whose corners leave the window read them from device memory
(`bf16_window_hit_share` counts those that do not).
"""
from __future__ import annotations

import ctypes

import torch

from romp_tpu_torch.models.layers import bf16_round
from romp_tpu_torch.ops import _build

TAPS = 9
# csrc/deform_conv.cu: K columns a chunk, output channels a CTA, float4 B
# fragments a chunk
CHUNK_COLS = 32
N_TILE = 32
FRAGS = 4 * 4 * 32
# csrc/deform_conv.cu: the pixel tile (kTH x kTW), a CTA's shared memory
TILE_H, TILE_W = 8, 16
MAX_SMEM = 232448
# the bf16 kernel: x's window around a tile (kEy rows and kEx columns each
# side) and its ring's stages at most (kMaxStages)
BF16_WIN_EY, BF16_WIN_EX = 8, 8
BF16_WIN_ROWS = TILE_H + 2 * BF16_WIN_EY
BF16_WIN_COLS = TILE_W + 2 * BF16_WIN_EX
BF16_MAX_STAGES = 8
BF16_PLAN_KEYS = ("ctas", "items", "stages", "ngc", "smem")
BWD_PLAN_KEYS = ("ctas", "ey", "ex", "wrows", "dw_smem", "smem",
                 "scratch_floats")
BF16_GRAD = (
    "deform_conv2d: the bf16 variant has no backward. TRACE trains in f32: "
    "its train step has no bf16-activation mode (the JAX package's "
    "TraceTrainConfig has no act_dtype), so the bf16 deform only runs in "
    "inference")


def deform_smem(G: int, Cg: int) -> int:
    """csrc/deform_conv.cu `smem_bytes`: three chunks of weight fragments,
    two of samples (128 pixels x CHUNK_COLS f32) and two of the offset
    planes of the groups a chunk touches (at most G)."""
    ngc = min(G, (CHUNK_COLS - 1) // Cg + 2)
    return 3 * FRAGS * 16 + (2 * 128 * CHUNK_COLS + 2 * 2 * ngc * 128) * 4


def deform_bf16_plan(B: int, C: int, H: int, W: int, G: int, Cout: int,
                     sms: int) -> dict:
    """csrc/deform_conv.cu `bf_plan` (`romp_deform_conv2d_bf16_plan`
    returns the kernel's own): the work items (output-channel tile, frame,
    16 x 8 pixel tile), `ctas` persistent CTAs (at most one an SM and one
    an item), `ngc` groups whose offset planes a ring stage holds, and as
    many `stages` (2 to 8) as fit the 232,448 bytes a CTA may take beside
    the mbarriers, the 9 taps' B fragments, two taps of samples, the
    slotted x window (72 bytes a pixel) and the planar one (`smem` bytes,
    128 of them to align the base). Raises ValueError for shapes the
    kernel does not take."""
    if min(B, C, H, W, G, Cout, sms) <= 0 or C % G:
        raise ValueError(f"deform_bf16_plan: no plan for B={B}, C={C}, "
                         f"H={H}, W={W}, G={G}, Cout={Cout}, sms={sms}")
    ngc = min(G, (CHUNK_COLS - 1) // (C // G) + 2)
    items = -(-Cout // N_TILE) * B * -(-H // TILE_H) * -(-W // TILE_W)
    pixels = BF16_WIN_ROWS * BF16_WIN_COLS
    for stages in range(BF16_MAX_STAGES, 1, -1):
        bars = -(-(2 * stages + 2) * 8 // 128) * 128
        smem = (bars + TAPS * 256 * 8 + 2 * 128 * (CHUNK_COLS + 8) * 2
                + pixels * (CHUNK_COLS * 2 + 8) + pixels * CHUNK_COLS * 2
                + stages * ngc * 2 * 128 * 4 + 128)
        if smem <= MAX_SMEM:
            return dict(ctas=min(items, sms), items=items, stages=stages,
                        ngc=ngc, smem=smem)
    raise ValueError(f"deform_bf16_plan: C={C}, G={G} does not fit")


def deform_bf16_work(plan: dict, B: int, H: int, W: int, cta: int) -> list:
    """The work items CTA `cta` of `plan` takes, in its order: (z, frame,
    tile row y0, tile column x0) of items i = cta, cta + ctas, ..., where
    i = (z * B + frame) * tiles + tile."""
    tiles_w = -(-W // TILE_W)
    tiles = tiles_w * -(-H // TILE_H)
    out = []
    for i in range(cta, plan["items"], plan["ctas"]):
        z, r = divmod(i, B * tiles)
        b, t = divmod(r, tiles)
        out.append((z, b, t // tiles_w * TILE_H, t % tiles_w * TILE_W))
    return out


def bf16_window_hit_share(offsets: torch.Tensor, deform_groups: int,
                          padding: int = 1) -> float:
    """The share of the bf16 kernel's samples (pixel, group, tap) whose four
    corners lie in the x window of their pixel's tile (its 16 x 8 pixels
    +- BF16_WIN_EY rows and +- BF16_WIN_EX columns, outside the image
    included), by the kernel's rule on its clamped coordinates; the
    others read their corners from device memory."""
    B, _, H, W = offsets.shape
    ys, xs = _sample_coords(offsets, deform_groups, H, W, padding)
    y0 = torch.floor(ys.clamp(-2.0, H + 1.0))
    x0 = torch.floor(xs.clamp(-2.0, W + 1.0))
    dev = offsets.device
    wy = (torch.arange(H, device=dev) // TILE_H * TILE_H
          - BF16_WIN_EY).view(H, 1)
    wx = (torch.arange(W, device=dev) // TILE_W * TILE_W
          - BF16_WIN_EX).view(1, W)
    hit = ((y0 >= wy) & (y0 < wy + BF16_WIN_ROWS - 1)
           & (x0 >= wx) & (x0 < wx + BF16_WIN_COLS - 1))
    return float(hit.float().mean())


def scratch_floats(B: int, C: int, H: int, W: int, Cout: int) -> int:
    """The kernel's scratch: the split weight fragments of every
    output-channel tile and chunk, then x regrouped as (B, G, H*W, C/G)."""
    return (-(-Cout // N_TILE) * TAPS * -(-C // CHUNK_COLS) * FRAGS * 4
            + B * C * H * W)


def _sample_coords(offsets: torch.Tensor, G: int, H: int, W: int,
                   padding: int):
    """The sample coordinates (ys, xs), each (B, G, 9, H, W): pixel + tap -
    padding + the tap's (dy, dx) offset; f32 (f64 for f64 offsets)."""
    B = offsets.shape[0]
    dt = torch.promote_types(offsets.dtype, torch.float32)
    off = offsets.reshape(B, G, TAPS, 2, H, W).to(dt)
    k = torch.arange(TAPS, device=offsets.device)
    ky = (k // 3 - padding).to(dt).view(1, 1, TAPS, 1, 1)
    kx = (k % 3 - padding).to(dt).view(1, 1, TAPS, 1, 1)
    yy = torch.arange(H, dtype=dt, device=offsets.device).view(
        1, 1, 1, H, 1)
    xx = torch.arange(W, dtype=dt, device=offsets.device).view(
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
    wk = weight.reshape(Cout, G, Cg, TAPS).to(samp.dtype)
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


def bwd_plan(B: int, C: int, H: int, W: int, G: int, Cout: int,
             sms: int) -> dict:
    """The backward kernel's launch plan on `sms` SMs, as csrc/deform_conv.cu
    `bwd_plan` makes it (`romp_deform_conv2d_bwd_plan`, so the CUDA library
    is built): `ctas` persistent CTAs (one an SM, at most one a tile); the
    dx windows, one a warp, of its group's channels over its `wrows` rows
    of the tile +- `ey` rows and the tile's columns +- `ex` (`ey` -1: none;
    only where the channels are one chunk and G is 4, 8 or 16); the dW
    partial in shared memory (`dw_smem`); `smem` bytes; `scratch_floats`.
    Raises ValueError for shapes whose smallest plan does not fit."""
    out = (ctypes.c_longlong * len(BWD_PLAN_KEYS))()
    if _build.load().romp_deform_conv2d_bwd_plan(
            B, C, H, W, G, Cout, sms, ctypes.addressof(out)):
        raise ValueError(
            f"deform_conv2d_backward: no plan for B={B}, C={C}, H={H}, "
            f"W={W}, G={G}, Cout={Cout}: the kernel's shared memory does "
            f"not hold its smallest one")
    return dict(zip(BWD_PLAN_KEYS, out))


def bwd_global_share(offsets: torch.Tensor, deform_groups: int,
                     padding: int, plan: dict) -> float:
    """The share of the backward's dx contributions (corners inside the
    image with a nonzero weight) that take global atomics, by the rule of
    `romp_deform_conv2d_bwd_f32`, computed from the offsets: those outside
    the window (the `plan["wrows"]` rows of the tile holding their pixel
    +- `ey`, the tile's columns +- `ex`; all where `ey` < 0), and all of a
    sample whose lane lost its top-left corner's tag. A warp's 32 lanes
    take 32 consecutive pixels of a tile at one tap and group; of the
    lanes with a corner in the window that share a top-left corner, one
    keeps the tag. The kernel does not fix which; this takes the first.
    Such lanes share their four corners, so their counts differ only
    where a corner's weight is exactly 0 for some of them."""
    B, _, H, W = offsets.shape
    G = deform_groups
    ey, ex, rows = plan["ey"], plan["ex"], plan["wrows"]
    ys, xs = _sample_coords(offsets, G, H, W, padding)   # (B, G, 9, H, W)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    dev = offsets.device
    ty = (torch.arange(H, device=dev) // rows * rows).view(H, 1)
    tx = (torch.arange(W, device=dev) // TILE_W * TILE_W).view(1, W)
    hits, in_win = [], []
    for dy, dxx, wt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                        (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        yy, xx = y0 + dy, x0 + dxx
        hit = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W) & (wt != 0)
        hits.append(hit)
        in_win.append(hit & (yy >= ty - ey) & (yy < ty + rows + ey)
                      & (xx >= tx - ex) & (xx < tx + TILE_W + ex)
                      if ey >= 0 else torch.zeros_like(hit))
    total = int(sum(int(h.sum()) for h in hits))
    n_in = sum(w.to(torch.int64) for w in in_win)
    owner = torch.ones_like(n_in, dtype=torch.bool)
    if ey >= 0:
        # the warp block of each pixel: its tile and which 32 of the
        # tile's 128 pixels, at this (frame, group, tap)
        py = torch.arange(H, device=dev).view(H, 1)
        px = torch.arange(W, device=dev).view(1, W)
        block = ((py // TILE_H * -(-W // TILE_W) + px // TILE_W) * 4
                 + (py % TILE_H * TILE_W + px % TILE_W) // 32)
        lane = (py % TILE_H * TILE_W + px % TILE_W) % 32
        lead = torch.arange(B * G * 9, device=dev).view(B, G, 9, 1, 1)
        cells = (H + 1) * (W + 1)
        key = ((lead * (block.max() + 1) + block) * cells
               + (y0.long() + 1) * (W + 1) + x0.long() + 1)
        any_in = n_in > 0
        k, ln = key[any_in], lane.expand_as(key)[any_in]
        _, group = torch.unique(k, return_inverse=True)
        first = torch.full((int(group.max()) + 1 if group.numel() else 0,),
                           32, dtype=ln.dtype, device=dev)
        first.scatter_reduce_(0, group, ln, "amin")
        owner[any_in] = ln == first[group]
    kept = int(n_in[owner].sum())
    return (total - kept) / max(total, 1)


def deform_conv2d_bwd_plain(x: torch.Tensor, offsets: torch.Tensor,
                            weight: torch.Tensor, gout: torch.Tensor,
                            deform_groups: int = 8, padding: int = 1):
    """Plain PyTorch backward of `deform_conv2d_plain` (f32): the cotangent
    gout (B, Cout, H, W) -> (dx (B, C, H, W), doffsets (B, G*18, H, W),
    dweight (Cout, C, 3, 3)), by the formulas of the module docstring:
    gathers for the samples and their differences, `scatter_add_` for dx."""
    B, C, H, W = x.shape
    G = deform_groups
    Cg = C // G
    Cout = weight.shape[0]
    n = TAPS * H * W
    ys, xs = _sample_coords(offsets, G, H, W, padding)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = (ys - y0).reshape(B, G, 1, n), (xs - x0).reshape(B, G, 1, n)
    hy, hx = 1.0 - ly, 1.0 - lx
    xg = x.reshape(B, G, Cg, H * W)
    wk = weight.reshape(Cout, G, Cg, TAPS)
    gcol = torch.einsum("ogck,bop->bgckp", wk,
                        gout.reshape(B, Cout, H * W)).reshape(B, G, Cg, n)

    def corner(yi, xi):
        """(values, flat indices, inside flags) of one corner."""
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).reshape(
            B, G, 1, n)
        idx = (yi.clamp(0, H - 1).long() * W
               + xi.clamp(0, W - 1).long()).reshape(B, G, 1, n)
        idx = idx.expand(B, G, Cg, n)
        return torch.gather(xg, 3, idx) * valid, idx, valid

    (v00, i00, m00), (v01, i01, m01), (v10, i10, m10), (v11, i11, m11) = (
        corner(y0, x0), corner(y0, x0 + 1), corner(y0 + 1, x0),
        corner(y0 + 1, x0 + 1))
    dly = (gcol * (hx * (v10 - v00) + lx * (v11 - v01))).sum(2)
    dlx = (gcol * (hy * (v01 - v00) + ly * (v11 - v10))).sum(2)
    doffsets = torch.stack([dly.reshape(B, G, TAPS, H, W),
                            dlx.reshape(B, G, TAPS, H, W)], dim=3)
    dxg = torch.zeros_like(xg)
    for idx, wt, valid in ((i00, hy * hx, m00), (i01, hy * lx, m01),
                           (i10, ly * hx, m10), (i11, ly * lx, m11)):
        dxg.scatter_add_(3, idx, gcol * (wt * valid))
    samp = (hy * hx * v00 + hy * lx * v01 + ly * hx * v10 + ly * lx * v11)
    dweight = torch.einsum("bop,bgckp->ogck", gout.reshape(B, Cout, H * W),
                           samp.reshape(B, G, Cg, TAPS, H * W))
    return (dxg.reshape(B, C, H, W), doffsets.reshape(B, G * 2 * TAPS, H, W),
            dweight.reshape(Cout, C, 3, 3))


def deform_conv2d_backward(x: torch.Tensor, offsets: torch.Tensor,
                           weight: torch.Tensor, gout: torch.Tensor,
                           deform_groups: int = 8, padding: int = 1):
    """The backward kernel (`csrc/deform_conv.cu`
    `romp_deform_conv2d_bwd_f32`) for CUDA tensors, `deform_conv2d_bwd_plain`
    for CPU tensors: (dx, doffsets, dweight), f32. dx is summed with
    float atomics (its last bits vary from run to run); dweight is summed
    over fixed per-CTA partials in a fixed order (bit-equal run to run).
    `deform_conv2d_backward.launches` counts launches (the prologue, the
    kernel and the reduction of one call are one launch)."""
    if x.device.type == "cpu":
        return deform_conv2d_bwd_plain(x, offsets, weight, gout,
                                       deform_groups, padding)
    B, C, H, W, G, Cout = _check_operands(
        "deform_conv2d_backward", x, offsets, weight, deform_groups,
        torch.float32, ("gout", gout))
    dx = torch.empty_like(x)
    doffsets = torch.empty_like(offsets)
    dweight = torch.empty_like(weight)
    if B == 0 or H * W == 0:
        return dx.zero_(), doffsets.zero_(), dweight.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = bwd_plan(B, C, H, W, G, Cout, sms)
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load().romp_deform_conv2d_bwd_f32(
            x.data_ptr(), offsets.data_ptr(), weight.data_ptr(),
            gout.data_ptr(), dx.data_ptr(), doffsets.data_ptr(),
            dweight.data_ptr(), scratch.data_ptr(), B, C, H, W, G, Cout,
            padding, sms, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "romp_deform_conv2d_bwd_f32")
    deform_conv2d_backward.launches += 1
    return dx, doffsets, dweight


deform_conv2d_backward.launches = 0


def _check_operands(what, x, offsets, weight, deform_groups, dtype, *more):
    """The kernels' operand checks: x a (B, C, H, W) CUDA tensor, C
    divisible by G; x, weight and `more` (further (name, tensor) pairs of
    the output's shape, f32) of `dtype`, offsets f32; all contiguous and on
    x's device."""
    if x.dim() != 4 or x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a (B, C, H, W) CUDA tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    B, C, H, W = x.shape
    G = deform_groups
    Cout = weight.shape[0]
    if C % G:
        raise ValueError(f"{what}: C={C} not divisible by G={G}")
    for name, t, dt, shape in (
            ("x", x, dtype, (B, C, H, W)),
            ("offsets", offsets, torch.float32, (B, G * 2 * TAPS, H, W)),
            ("weight", weight, dtype, (Cout, C, 3, 3)),
            *((n, t, torch.float32, (B, Cout, H, W)) for n, t in more)):
        _build.check_operand(what, name, t, dt, shape, x.device)
    return B, C, H, W, G, Cout


class _DeformConv2d(torch.autograd.Function):
    """deform_conv2d with its backward (`pallas_deform.py:154-186`): saves
    x, offsets and weight, as `_fast_fwd` does."""

    @staticmethod
    def forward(ctx, x, offsets, weight, deform_groups, padding):
        ctx.save_for_backward(x, offsets, weight)
        ctx.deform_groups, ctx.padding = deform_groups, padding
        return _deform_forward(x, offsets, weight, deform_groups, padding)

    @staticmethod
    def backward(ctx, gout):
        x, offsets, weight = ctx.saved_tensors
        dx, doffsets, dweight = deform_conv2d_backward(
            x, offsets, weight, gout.contiguous(), ctx.deform_groups,
            ctx.padding)
        return dx, doffsets, dweight, None, None


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, deform_groups: int = 8,
                  padding: int = 1) -> torch.Tensor:
    """Deformable conv: the CUDA kernel for CUDA tensors,
    `deform_conv2d_plain` for CPU tensors. x and weight f32 (the f32
    kernel) or both bf16 (its bf16 variant); offsets f32; the output f32.
    See the module docstring for shapes. Differentiable in x, offsets and
    weight when they are f32 (`_DeformConv2d`); the bf16 variant has no
    backward and raises under grad mode on CUDA tensors.
    `deform_conv2d.launches` counts forward kernel launches,
    `deform_conv2d.bf16_launches` the bf16 variant's.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, offsets, weight)):
        if x.dtype != torch.bfloat16:
            return _DeformConv2d.apply(x, offsets, weight, deform_groups,
                                       padding)
        if x.device.type == "cuda":
            raise RuntimeError(BF16_GRAD)
    return _deform_forward(x, offsets, weight, deform_groups, padding)


def _deform_forward(x: torch.Tensor, offsets: torch.Tensor,
                    weight: torch.Tensor, deform_groups: int,
                    padding: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, weight, deform_groups, padding)
    bf16 = x.dtype == torch.bfloat16
    B, C, H, W, G, Cout = _check_operands(
        "deform_conv2d", x, offsets, weight, deform_groups,
        torch.bfloat16 if bf16 else torch.float32)
    out = torch.empty((B, Cout, H, W), dtype=torch.float32, device=x.device)
    if B == 0 or H * W == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:   # one launch, no scratch
            entry = "romp_deform_conv2d_bf16"
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            err = _build.load().romp_deform_conv2d_bf16(
                x.data_ptr(), offsets.data_ptr(), weight.data_ptr(),
                out.data_ptr(), B, C, H, W, G, Cout, padding, sms, stream)
        else:
            entry = "romp_deform_conv2d_f32"
            scratch = torch.empty(scratch_floats(B, C, H, W, Cout),
                                  dtype=torch.float32, device=x.device)
            err = _build.load().romp_deform_conv2d_f32(
                x.data_ptr(), offsets.data_ptr(), weight.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), B, C, H, W, G, Cout,
                padding, stream)
    _build.check(err, entry)
    deform_conv2d.launches += 1
    deform_conv2d.bf16_launches += bf16
    return out


deform_conv2d.launches = 0
deform_conv2d.bf16_launches = 0
