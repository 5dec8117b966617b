"""Fused chain of stride-1 HRNet BasicBlocks (inference): the hand-written
CUDA kernel and its plain twin.

Counterpart of `romp_tpu/ops/pallas_fuse.py`. Each BasicBlock is
conv3x3 -> folded BN -> ReLU -> conv3x3 -> folded BN + residual -> ReLU,
with the mixed-path numerics of the TPU kernel: conv operands rounded to
bf16, f32 accumulation, f32 BN / residual / ReLU. The kernel
(`romp_tpu_torch/csrc/basic_chain.cu`) is one conv pass on the tensor
cores, an implicit GEMM whose launch plan `launch_plan` picks here; a
block is two launches.

Layouts: activations are NCHW (the port's network layout) in f32. The
kernel reads its conv operand as bf16 NHWC: a chain's input and a single
pass's input are converted once by a transposing kernel; inside a chain
each pass writes the bf16 NHWC operand of the next (conv1's output h only
so; each block output y also in f32 NCHW, the next block's residual). The
packed weights keep the TPU kernel's layout, w[n, j, dy*C + ci, dx*C + co],
so they compare with `pallas_fuse.pack_chain_weights` bit for bit.

bf16 in and out (the bf16-activation path): the TPU kernel widens a bf16
input to f32, runs the chain in f32 and rounds its result to bf16
(`pallas_fuse.py:145-146, 174`). `basic_chain` on a bf16 x runs one of two
designs, as `bf16_chain_plan` picks: where C is 32 or 64 (the two widest
HRNet maps) and W % 8 == 0 (TMA's 16-byte rows), the fused block kernel (`csrc/chain_block_bf16.cu`, one launch
a BasicBlock, h kept in shared memory, x read as bf16 NCHW, the inner
block outputs f32); elsewhere the passes' bf16 variant (the conversion
reads bf16 NCHW; block 0's residual is x, widened exactly; the last pass
writes bf16 NCHW). Both are bit-equal to the f32 chain on x.float(),
rounded; `basic_chain_plain` has the same dtype contract.

Forward only: under grad mode with an operand that requires grad the
kernel wrappers raise, where the plain twins (the CPU's) would carry the
graph (the training slice brings the backward).
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Optional, Tuple

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
    f32 or bf16 -> same shape and dtype; a bf16 x is widened to f32 and the
    f32 result rounded to bf16 at the end."""
    y = x.float()
    for n in range(blocks):
        h = conv_pass_plain(y, w[n, 0], scale[n, 0], shift[n, 0])
        y = conv_pass_plain(h, w[n, 1], scale[n, 1], shift[n, 1], residual=y)
    return y.to(x.dtype)


# The kernel's fixed shape (basic_chain.cu): output tiles of tile_h x 8
# pixels, K in chunks of 32 input channels, two cp.async stages; 128
# threads, 256 for the (32, 64) tile.
TILE_W = 8
CHUNK = 32
STAGES = 2
# (tile_h, tile_n) instantiations, most work per CTA first
TILES = ((32, 64), (16, 64), (32, 32), (8, 64), (16, 32), (8, 32), (4, 32))
MIN_CTAS = 128          # about one wave of the H100's 132 SMs
SMEM_LIMIT = 232_448    # shared memory a block can use on Hopper


# The fused bf16 block kernel's instantiations (csrc/chain_block_bf16.cu
# `kInsts`): C -> (tile_h, tile_w, consumer warps). Its CTAs also hold a
# producer warpgroup, of which one warp loads.
FUSED_TILES = {32: (16, 16, 8), 64: (8, 8, 8)}
FUSED_MAX_STAGES = 2
CARD_SMS = 132          # the H100 SXM's SMs (the plan's default)


class ChainPlan(NamedTuple):
    tile_h: int     # output tile rows (the tile is tile_h x TILE_W pixels)
    tile_n: int     # output channels per CTA
    ksplit: int     # CTAs that share one output tile's K (CHUNK chunks)
    smem: int       # dynamic shared memory per CTA, bytes
    ctas: int


def smem_bytes(tile_h: int, tile_n: int) -> int:
    """Shared memory of one CTA: per stage the halo tile (rows of CHUNK + 8
    bf16 values, padded against bank conflicts) and 9 x CHUNK weight rows
    of tile_n + 8 bf16 values. The residual's prefetched block takes the
    stage that the last chunk frees."""
    a = (tile_h + 2) * (TILE_W + 2) * (CHUNK + 8)
    b = 9 * CHUNK * (tile_n + 8)
    return STAGES * 2 * (a + b)


def candidate_plans(B: int, C: int, H: int, W: int):
    """Every plan the kernel takes for this shape, in order of K split (1
    first, then the divisors of the chunk count) and then of tile size
    (largest first). Tiles of 64 output channels only where they divide C,
    and no taller than H rounded up to 8 rows."""
    chunks = -(-C // CHUNK)
    tiles = [(th, tn) for th, tn in TILES
             if (tn == 32 or C % tn == 0) and th <= -(-H // 8) * 8]
    for ksplit in (k for k in range(1, chunks + 1) if chunks % k == 0):
        for th, tn in tiles:
            ctas = (B * -(-H // th) * -(-W // TILE_W) * -(-C // tn)
                    * ksplit)
            yield ChainPlan(th, tn, ksplit, smem_bytes(th, tn), ctas)


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, C: int, H: int, W: int) -> ChainPlan:
    """The first candidate plan that gives at least MIN_CTAS CTAs; where
    none does, the first with the most CTAs."""
    best = None
    for plan in candidate_plans(B, C, H, W):
        if plan.ctas >= MIN_CTAS:
            return plan
        if best is None or plan.ctas > best.ctas:
            best = plan
    return best


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def fused_smem(C: int, tile_h: int, tile_w: int, stages: int) -> int:
    """Shared memory of one fused block CTA (chain_block_bf16.cu `Geo`):
    both convs' weights (9C rows of C bf16 values each, swizzled), the
    window A (pixel rows of C bf16 values, swizzled; its place also holds
    conv2's sums, C f32 planes of the tile padded by 4), h's region (rows
    as A's), both convs' scale and shift (f32), the mbarriers (two a
    stage, for up to FUSED_MAX_STAGES), then
    `stages` staging buffers of the window in f32 (rows from the 16-byte
    boundary 4 columns left of the tile, tile_w + 6 columns rounded up to
    16 bytes; each buffer rounded to 128), and 1024 bytes to align the
    base."""
    win = (tile_h + 4) * (tile_w + 4)
    hreg = (tile_h + 2) * (tile_w + 2)
    a = max(win * C * 2, C * (tile_h * tile_w + 4) * 4)
    off = _align128(2 * 9 * C * C * 2 + a + hreg * C * 2 + 4 * C * 4
                    + 2 * FUSED_MAX_STAGES * 8)
    stage = _align128(C * (tile_h + 4) * (-(-(tile_w + 6) // 4) * 4) * 4)
    return off + stages * stage + 1024


class Bf16ChainPlan(NamedTuple):
    fused: bool     # one launch a block (chain_block_bf16.cu); else passes
    tile_h: int     # output tile rows
    tile_w: int     # output tile columns
    warps: int      # MMA warps a CTA (fused: plus a producer warpgroup)
    cluster: int    # CTAs a cluster (1: no clusters)
    stages: int     # staging buffers (fused) or cp.async stages (passes)
    smem: int       # dynamic shared memory a CTA, bytes
    ctas: int       # CTAs a launch (fused: persistent, at most one an SM)
    tiles: int      # output tiles a launch
    launches_per_block: int   # conv kernel launches a BasicBlock
    passes: Optional[ChainPlan]   # the passes' plan where not fused


@functools.lru_cache(maxsize=None)
def bf16_chain_plan(B: int, C: int, H: int, W: int,
                    sms: int = CARD_SMS) -> Bf16ChainPlan:
    """The bf16 chain's design for a shape on `sms` SMs. Fused where the
    block kernel has an instantiation for C (FUSED_TILES), where W % 8 == 0
    (the kernel reads its input by TMA, whose rows are 16-byte aligned;
    a copy path there was 3-4.5x slower than the passes), where the f32
    chain sums K in one piece (its plan has no K split: the bf16 chain
    stays bit-equal to it) and where the tensor has fewer than 2^31
    elements; the persistent CTAs then number min(tiles, sms), with as
    many staging buffers as fit (up to FUSED_MAX_STAGES). Elsewhere the
    passes, at `launch_plan`'s plan."""
    passes = launch_plan(B, C, H, W)
    if (C in FUSED_TILES and W % 8 == 0 and passes.ksplit == 1
            and B * C * H * W < 2 ** 31):
        th, tw, warps = FUSED_TILES[C]
        tiles = B * -(-H // th) * -(-W // tw)
        for stages in range(FUSED_MAX_STAGES, 0, -1):
            smem = fused_smem(C, th, tw, stages)
            if smem <= SMEM_LIMIT:
                return Bf16ChainPlan(True, th, tw, warps, 1, stages, smem,
                                     min(tiles, sms), tiles, 1, None)
    threads = 256 if (passes.tile_h, passes.tile_n) == (32, 64) else 128
    return Bf16ChainPlan(
        False, passes.tile_h, TILE_W, threads // 32, 1, STAGES, passes.smem,
        passes.ctas, B * -(-H // passes.tile_h) * -(-W // TILE_W), 2, passes)


def bf16_chain_bytes(plan: Bf16ChainPlan, blocks: int) -> int:
    """Device-memory bytes an element of a `blocks`-block bf16 chain moves
    under `plan`, halo rereads not counted. Fused: each block reads its
    input (bf16 x, then the f32 inner outputs) and writes its output (f32,
    the last bf16). Passes: the conversion (2 + 2), each conv1 reads its
    bf16 operand and writes h (2 + 2), each conv2 reads h, reads the
    residual (bf16 x, then f32) and writes the output (f32 and a bf16 NHWC
    copy, the last bf16 NCHW)."""
    if plan.fused:
        return sum((2 if n == 0 else 4) + (2 if n == blocks - 1 else 4)
                   for n in range(blocks))
    return 4 + sum(4 + 2 + (2 if n == 0 else 4)
                   + (2 if n == blocks - 1 else 6) for n in range(blocks))


def _check_operands(x, w, scale, shift, lead=(), x_dtype=torch.float32
                    ) -> None:
    """Raise unless the operands are what the kernel reads: x (B, C, H, W)
    of x_dtype on a CUDA device with C a multiple of 8, w (*lead, 3C, 3C)
    bf16, scale and shift (*lead, C) f32, all on x's device and contiguous,
    none requiring grad under grad mode."""
    if x.dim() != 4 or x.device.type != "cuda":
        raise ValueError(f"basic_chain: x must be a (B, C, H, W) CUDA "
                         f"tensor, got {tuple(x.shape)} on {x.device}")
    C = x.shape[1]
    if C % 8:
        raise ValueError(f"basic_chain: C={C}; the kernel takes channel "
                         f"counts that are multiples of 8")
    _build.check_no_grad("basic_chain", x, w, scale, shift)
    for name, t, dtype, shape in (
            ("x", x, x_dtype, x.shape),
            ("w", w, torch.bfloat16, (*lead, 3 * C, 3 * C)),
            ("scale", scale, torch.float32, (*lead, C)),
            ("shift", shift, torch.float32, (*lead, C))):
        _build.check_operand("basic_chain", name, t, dtype, shape, x.device)


def _stream(x: torch.Tensor) -> int:
    """The raw handle of x's device's current stream. Not
    `torch.cuda.current_stream()`, which builds a Stream object on every
    call: host time that a small batch feels."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _scratch(x: torch.Tensor, plan: ChainPlan, n_bf16: int, n_f32: int):
    """One allocation for the kernel's scratch (each allocation costs
    microseconds of host time, which a small batch feels): n_bf16 bf16
    buffers and n_f32 f32 buffers of x's size, then the K-split workspace.
    Returns the tensor that owns them, their pointers, and the workspace's
    pointer (None without a split). C % 8 == 0 keeps each buffer 16-byte
    aligned, as cp.async needs."""
    n = x.numel()
    ws = plan.ksplit * n * 4 if plan.ksplit > 1 else 0
    buf = torch.empty(n * (2 * n_bf16 + 4 * n_f32) + ws, dtype=torch.uint8,
                      device=x.device)
    ptrs = [buf.data_ptr() + 2 * n * i for i in range(n_bf16)]
    f32 = buf.data_ptr() + 2 * n * n_bf16
    ptrs += [f32 + 4 * n * i for i in range(n_f32)]
    return buf, ptrs, (f32 + 4 * n * n_f32 if ws else None)


def conv_pass(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              shift: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv pass of the chain: the CUDA kernel for CUDA tensors,
    `conv_pass_plain` for CPU tensors. Returns f32 NCHW.
    `conv_pass.launches` counts the conv kernel's launches, here and inside
    `basic_chain`."""
    if x.device.type == "cpu":
        return conv_pass_plain(x, w, scale, shift, residual)
    _check_operands(x, w, scale, shift)
    _build.check_no_grad("conv_pass", residual)
    if residual is not None:
        _build.check_operand("basic_chain", "residual", residual,
                             torch.float32, x.shape, x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = launch_plan(*x.shape)
    _owner, (xb,), partial = _scratch(x, plan, 1, 0)
    with torch.cuda.device(x.device):
        err = _build.load().romp_conv3x3_bn_act(
            x.data_ptr(), xb, w.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), _ptr(residual), out.data_ptr(), partial,
            *x.shape, plan.tile_h, plan.tile_n, plan.ksplit, plan.smem,
            _stream(x))
    _build.check(err, "romp_conv3x3_bn_act")
    conv_pass.launches += 1
    return out


def basic_chain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor, blocks: int) -> torch.Tensor:
    """Run `blocks` BasicBlocks over x (B, C, H, W) f32 or bf16 (the result
    in x's dtype): the CUDA kernel (two launches a block, from one host
    call) for CUDA tensors, `basic_chain_plain` for CPU tensors. f32:
    bit-equal to the same passes through `conv_pass`; bf16: the kernel's
    bf16 variant, bit-equal to the f32 chain on x.float(), rounded to bf16.
    Another dtype raises."""
    if x.device.type == "cpu":
        return basic_chain_plain(x, w, scale, shift, blocks)
    if x.dtype == torch.bfloat16:
        return _basic_chain_bf16(x, w, scale, shift, blocks)
    _check_operands(x, w, scale, shift, lead=(blocks, 2))
    if blocks == 0:
        return x
    if x.numel() == 0:
        return torch.empty_like(x)
    plan = launch_plan(*x.shape)
    # bf16 operand of each conv1 (then bf16(y)), conv1's output h (bf16
    # only), and the f32 buffer the block outputs alternate with
    _owner, (xb, h, tmp), partial = _scratch(x, plan, 2, 1)
    out = torch.empty_like(x)
    # block n's output goes to outs[(n - 1) % 2]: the last one to out
    outs = (out.data_ptr(), tmp) if blocks % 2 else (tmp, out.data_ptr())
    with torch.cuda.device(x.device):
        err = _build.load().romp_basic_chain(
            x.data_ptr(), xb, h, *outs, partial, w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), blocks,
            *x.shape, plan.tile_h, plan.tile_n, plan.ksplit, plan.smem,
            _stream(x))
    _build.check(err, "romp_basic_chain")
    conv_pass.launches += 2 * blocks
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _basic_chain_bf16(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, blocks: int) -> torch.Tensor:
    """basic_chain's bf16 variant (CUDA tensors), as `bf16_chain_plan`
    picks: `romp_chain_bf16_fused` (one launch a block; nothing allocated
    beside the output but the inner blocks' f32 outputs) or
    `romp_basic_chain_bf16` (the passes). Raises where x's data is not
    16-byte aligned: TMA cannot read it, and the passes' vector loads
    fault on it. Counts its conv launches in
    `basic_chain.bf16_launches` as well as in `conv_pass.launches`, and
    the fused kernel's also in `basic_chain.bf16_fused_launches`."""
    _check_operands(x, w, scale, shift, lead=(blocks, 2),
                    x_dtype=torch.bfloat16)
    if blocks == 0:
        return x
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.data_ptr() % 16:
        raise ValueError("basic_chain: a bf16 x's data must be 16-byte "
                         "aligned")
    sms = _sms(x.device.index)
    fplan = bf16_chain_plan(*x.shape, sms)
    if fplan.fused:
        # the inner blocks' f32 outputs alternate in y0 / y1
        n_f32 = min(blocks - 1, 2)
        ys = (torch.empty(n_f32 * x.numel(), dtype=torch.float32,
                          device=x.device) if n_f32 else None)
        y0 = ys.data_ptr() if n_f32 >= 1 else None
        y1 = y0 + 4 * x.numel() if n_f32 == 2 else None
        with torch.cuda.device(x.device):
            err = _build.load().romp_chain_bf16_fused(
                x.data_ptr(), y0, y1, out.data_ptr(), w.data_ptr(),
                scale.data_ptr(), shift.data_ptr(), blocks, *x.shape,
                fplan.tile_h, fplan.tile_w, fplan.warps, fplan.stages,
                fplan.smem, fplan.ctas, sms, _stream(x))
        _build.check(err, "romp_chain_bf16_fused")
        conv_pass.launches += blocks
        basic_chain.bf16_launches += blocks
        basic_chain.bf16_fused_launches += blocks
        return out
    plan = fplan.passes
    # bf16 NHWC operands of conv1 and conv2, and the two f32 buffers the
    # inner blocks' outputs alternate in
    _owner, (xb, h, y0, y1), partial = _scratch(x, plan, 2, 2)
    with torch.cuda.device(x.device):
        err = _build.load().romp_basic_chain_bf16(
            x.data_ptr(), xb, h, y0, y1, out.data_ptr(), partial,
            w.data_ptr(), scale.data_ptr(), shift.data_ptr(), blocks,
            *x.shape, plan.tile_h, plan.tile_n, plan.ksplit, plan.smem,
            _stream(x))
    _build.check(err, "romp_basic_chain_bf16")
    conv_pass.launches += 2 * blocks
    basic_chain.bf16_launches += 2 * blocks
    return out


conv_pass.launches = 0
basic_chain.bf16_launches = 0
basic_chain.bf16_fused_launches = 0
