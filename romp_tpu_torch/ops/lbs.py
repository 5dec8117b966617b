"""Linear-blend skinning: the hand-written CUDA kernel and its plain twin.

Counterpart of `romp_tpu/ops/pallas_lbs.py`. The kernel
(`romp_tpu_torch/csrc/lbs.cu`) computes, per person b and vertex v,

    T16 = A16[b] . W^T
    verts[b, m, v] = sum_n T16[4m+n, v] * v_posed[b, n, v] + T16[4m+3, v]

without ever writing the (B, 16, V) transform block, on the tensor cores
in split TF32 (`tf32_round`, `split_tf32_matmul` model its arithmetic).
`skinning_plan` picks the kernel's launch.

`skinning` is differentiable: its backward is the analytic one of
`pallas_lbs.py:113-126` (`_fused_skinning_bwd`), for the cotangent g,

    dv[b, n, v] = sum_m T16[b, 4m+n, v] * g[b, m, v]
    dA16[b, 4m+n, j] = sum_v g[b, m, v] * vh[b, n, v] * W[v, j]

with vh = [v_posed; 1], rows 12-15 of dA16 zero and no gradient for the
lbs weights (JAX gives them a zero cotangent). On CUDA tensors it is a
second kernel of `csrc/lbs.cu` (`skinning_backward`); `skinning_bwd_plain`
is its twin. A CTA owns 16 persons and one segment of V, recomputes T16 in
registers for dv as the forward does, and keeps its persons' dA16 in
registers over the whole segment; `skinning_bwd_plan` picks the segments
(one where the persons alone fill the card, at N = 4096), and a second
kernel adds the segments' partials in order. Bytes bind on paper (g and
v_posed read, dv written: 0.307 ms at N = 4096 at 3.35 TB/s), but the
split-TF32 `mma.sync` products hold the tensor cores about as long, and
the parts add up: 0.890-0.896 ms of device time at N = 4096, 0.130 ms at
the train steps' N = 512, on an H100 80GB HBM3 at 700 W (34% and 30% of
the bound; the previous design 1.223-1.233 and 0.172 ms, PERF.md).

Both are bound as `torch.library` custom ops, `romp_tpu_torch::skinning`
and `romp_tpu_torch::skinning_bwd` (the second the first's registered
autograd), so that an exported program (`tools/export_program.py`) holds
the kernel as a node.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from romp_tpu_torch.ops import _build

# csrc/lbs.cu: persons per pipeline step, cp.async ring depth, vertices per
# warp, warps and persons per CTA at most (32 persons ran 2-3% faster than
# 64 or 128 at N = 4096 on the H100), shared memory a CTA may take
CHUNK = 4
STAGES = 4
WARP_VERTS = 32
MAX_WARPS = 8
MAX_PERSONS = 32
MAX_SMEM = 232448
# two CTAs on each of the H100's 132 SMs, and the person tiles' waves
# (CTAs over that) at least 4 deep before persons per CTA grow
TARGET_CTAS = 2 * 132
WAVES = 4
# csrc/lbs.cu's backward: persons per CTA (4 warp pairs of 4 persons),
# vertices per ring stage (a pair's two warps, 32 each), ring stages; and
# the shared memory of one SM that CTAs may take (228 KB, of which each
# resident CTA reserves 1 KB)
BWD_PERSONS = 16
BWD_SUB = 64
BWD_RING = 2
SM_SMEM = 233472
CTA_RESERVED_SMEM = 1024


class SkinningPlan(NamedTuple):
    warps: int      # warps per CTA, 32 vertices each
    persons: int    # persons per CTA (a multiple of CHUNK)
    grid_v: int     # vertex tiles
    grid_n: int     # person tiles
    smem: int       # dynamic shared memory per CTA, bytes

    @property
    def ctas(self) -> int:
        return self.grid_v * self.grid_n


def skinning_smem(warps: int) -> int:
    """csrc/lbs.cu `smem_bytes`: the ring's stages (A16 rows 0-11 and
    v_posed rows padded by 8 for CHUNK persons) and two chunks of split B
    fragments (2 pairs x 3 x 3 k steps x 32 lanes x float4)."""
    vt = warps * WARP_VERTS
    return STAGES * (CHUNK * 12 * 24 + CHUNK * 3 * (vt + 8)) * 4 \
        + 2 * (2 * 3 * 3 * 32) * 16


def skinning_plan(n: int, v: int) -> SkinningPlan:
    """The kernel's launch for n persons and v vertices. Warps per CTA
    halve from 8 until the tiles of CHUNK persons x 32 * warps vertices
    give TARGET_CTAS CTAs (or one warp is left); then each CTA takes as
    many chunks of persons (at most MAX_PERSONS) as keeps WAVES waves of
    TARGET_CTAS, so that the W tile in registers serves many persons."""
    chunks = -(-n // CHUNK)
    warps = MAX_WARPS
    while warps > 1 and -(-v // (warps * WARP_VERTS)) * chunks < TARGET_CTAS:
        warps //= 2
    grid_v = -(-v // (warps * WARP_VERTS))
    per = max(1, min(MAX_PERSONS // CHUNK,
                     grid_v * chunks // (WAVES * TARGET_CTAS)))
    persons = CHUNK * per
    return SkinningPlan(warps, persons, grid_v, -(-n // persons),
                        skinning_smem(warps))


class SkinningBwdPlan(NamedTuple):
    segments: int   # vertex segments (grid x), each one CTA's per person group
    seg_verts: int  # vertices per segment, a multiple of BWD_SUB
    groups: int     # person groups of BWD_PERSONS (grid y)
    smem: int       # dynamic shared memory per CTA, bytes

    @property
    def ctas(self) -> int:
        return self.segments * self.groups

    def partial_shape(self, n: int):
        """The dA16 partials' scratch, one per (segment, person), rows
        0-11; None where one segment writes dA16 itself."""
        return None if self.segments == 1 else (self.segments, n, 12, 24)


def skinning_bwd_smem() -> int:
    """csrc/lbs.cu `bwd_smem_bytes`: the split A16 fragments of the CTA's
    persons (8 pairs x 3 m x 3 k steps x 32 lanes x float4), the split W
    fragments of a stage in both layouts (the m16 tiles' hi and lo A
    fragments, the 8-vertex k steps' B fragments), and the ring's stages
    (v_posed and g rows of BWD_PERSONS persons x BWD_SUB vertices)."""
    a16 = (BWD_PERSONS // 2) * 3 * 3 * 32
    wa = (BWD_SUB // 16) * 3 * 32 * 2
    wb = (BWD_SUB // 8) * 3 * 32
    return (a16 + wa + wb) * 16 + BWD_RING * 2 * BWD_PERSONS * 3 * BWD_SUB * 4


def skinning_bwd_plan(n: int, v: int) -> SkinningBwdPlan:
    """The backward's launch for n persons and v vertices. A CTA owns
    BWD_PERSONS persons and one vertex segment, and keeps their dA16 in
    registers over it. Segments (whole stages of BWD_SUB vertices) split V
    as far as TARGET_CTAS CTAs (two an SM) ask: at N = 4096 the 256 person
    groups fill the card with one segment, which then writes dA16 with no
    partials; at N = 512 8 segments, at N = 64 54."""
    groups = -(-n // BWD_PERSONS)
    subs = -(-v // BWD_SUB)
    per = -(-subs // min(subs, max(1, TARGET_CTAS // groups)))
    return SkinningBwdPlan(-(-subs // per), per * BWD_SUB, groups,
                           skinning_bwd_smem())


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero: what `cvt.rna.tf32.f32` does. Finite inputs."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF      # add half an ulp of TF32, cut
    return bits.view(torch.float32)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                      terms: int = 3) -> torch.Tensor:
    """a @ b as the kernels compute it: each operand split into hi =
    tf32(x) and lo = tf32(x - hi); with terms=3 the sum lo.hi + hi.lo +
    hi.hi (the lo.lo product is left out), with terms=1 hi.hi alone (one
    TF32 product). Every product is exact in f32; the sums are f32."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi.double() @ b_hi.double()
    if terms == 3:
        a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
        out = out + a_lo.double() @ b_hi.double() \
            + a_hi.double() @ b_lo.double()
    return out.float()


def skinning_plain(a16: torch.Tensor, weights: torch.Tensor,
                   v_posed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch skinning (twin of `skinning_xla`, materializes T16).

    a16: (B, 16, J); weights: (V, J); v_posed: (B, 3, V) -> (B, 3, V).
    """
    t16 = torch.einsum("bkj,vj->bkv", a16, weights)
    return torch.stack([
        t16[:, 4 * m + 0] * v_posed[:, 0] + t16[:, 4 * m + 1] * v_posed[:, 1]
        + t16[:, 4 * m + 2] * v_posed[:, 2] + t16[:, 4 * m + 3]
        for m in range(3)], dim=1)


def skinning_bwd_plain(a16: torch.Tensor, weights: torch.Tensor,
                       v_posed: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch backward of skinning (twin of `_fused_skinning_bwd`,
    materializes T16): cotangent g (B, 3, V) -> (dA16 (B, 16, J), dv
    (B, 3, V))."""
    B, _, J = a16.shape
    t16 = torch.einsum("bkj,vj->bkv", a16, weights)
    dv = torch.stack([
        sum(t16[:, 4 * m + n] * g[:, m] for m in range(3))
        for n in range(3)], dim=1)
    vh = torch.cat([v_posed, torch.ones_like(v_posed[:, :1])], dim=1)
    da_mn = torch.einsum("bmv,bnv,vj->bmnj", g, vh, weights)   # (B, 3, 4, J)
    da16 = torch.cat([da_mn.reshape(B, 12, J), da_mn.new_zeros((B, 4, J))],
                     dim=1)
    return da16, dv


def _check_operands(what, a16, weights, v_posed, *more):
    """The kernels' operand checks: f32, contiguous, on a16's CUDA device;
    `more` are further (name, tensor) pairs of v_posed's shape."""
    if a16.dim() != 3 or a16.device.type != "cuda":
        raise ValueError(f"{what}: a16 must be a (B, 16, 24) CUDA tensor, "
                         f"got {tuple(a16.shape)} on {a16.device}")
    B, V = a16.shape[0], weights.shape[0]
    for name, t, shape in (("a16", a16, (B, 16, 24)),
                           ("weights", weights, (V, 24)),
                           ("v_posed", v_posed, (B, 3, V)),
                           *((n, t, (B, 3, V)) for n, t in more)):
        _build.check_operand(what, name, t, torch.float32, shape, a16.device)
    return B, V


def _skinning_cuda(a16: torch.Tensor, weights: torch.Tensor,
                   v_posed: torch.Tensor) -> torch.Tensor:
    """The forward kernel (`csrc/lbs.cu` `romp_skinning_f32`): the CUDA
    implementation of `romp_tpu_torch::skinning`."""
    B, V = _check_operands("skinning", a16, weights, v_posed)
    out = torch.empty((B, 3, V), dtype=torch.float32, device=a16.device)
    if B == 0:
        return out
    if a16.data_ptr() % 16:      # the kernel's 16-byte copies of A16 rows
        a16 = a16.clone()
    plan = skinning_plan(B, V)
    lib = _build.load()
    with torch.cuda.device(a16.device):
        err = lib.romp_skinning_f32(
            a16.data_ptr(), weights.data_ptr(), v_posed.data_ptr(),
            out.data_ptr(), B, V, 24, plan.warps, plan.persons,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "romp_skinning_f32")
    skinning.launches += 1
    return out


def _skinning_bwd_cuda(a16: torch.Tensor, weights: torch.Tensor,
                       v_posed: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels (`csrc/lbs.cu` `romp_skinning_bwd_f32`): the
    CUDA implementation of `romp_tpu_torch::skinning_bwd`."""
    B, V = _check_operands("skinning_backward", a16, weights, v_posed,
                           ("g", g))
    da16 = torch.empty((B, 16, 24), dtype=torch.float32, device=a16.device)
    dv = torch.empty((B, 3, V), dtype=torch.float32, device=a16.device)
    if B == 0:
        return da16, dv
    plan = skinning_bwd_plan(B, V)
    shape = plan.partial_shape(B)
    # dA16 partial sums, one per (segment, person), where V is split
    partial = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=a16.device)
    lib = _build.load()
    with torch.cuda.device(a16.device):
        err = lib.romp_skinning_bwd_f32(
            a16.data_ptr(), weights.data_ptr(), v_posed.data_ptr(),
            g.data_ptr(), dv.data_ptr(),
            None if partial is None else partial.data_ptr(), da16.data_ptr(),
            B, V, 24, plan.seg_verts, plan.segments,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "romp_skinning_bwd_f32")
    skinning_backward.launches += 1
    return da16, dv


# The kernels as custom operators, so that `torch.export` (whose fake
# tensors have no storage for a ctypes call) records them as graph nodes
# and a loaded program calls them again: CUDA tensors take the kernels,
# CPU tensors the plain versions; the fake implementations give the
# outputs' shapes and types (those of the inputs: the CPU tests run f64).
_skinning_op = torch.library.custom_op(
    "romp_tpu_torch::skinning", _skinning_cuda, mutates_args=(),
    device_types="cuda")
_skinning_op.register_kernel("cpu")(skinning_plain)
_skinning_bwd_op = torch.library.custom_op(
    "romp_tpu_torch::skinning_bwd", _skinning_bwd_cuda, mutates_args=(),
    device_types="cuda")
_skinning_bwd_op.register_kernel("cpu")(skinning_bwd_plain)


@_skinning_op.register_fake
def _skinning_fake(a16, weights, v_posed):
    return v_posed.new_empty(v_posed.shape)


@_skinning_bwd_op.register_fake
def _skinning_bwd_fake(a16, weights, v_posed, g):
    return a16.new_empty(a16.shape), v_posed.new_empty(v_posed.shape)


def _skinning_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _skinning_grad(ctx, g):
    """`pallas_lbs.py:113-126`: gradients for a16 and v_posed, none for
    the lbs weights."""
    a16, weights, v_posed = ctx.saved_tensors
    da16, dv = skinning_backward(a16, weights, v_posed, g.contiguous())
    return da16, None, dv


_skinning_op.register_autograd(_skinning_grad, setup_context=_skinning_setup)


def skinning_backward(a16: torch.Tensor, weights: torch.Tensor,
                      v_posed: torch.Tensor, g: torch.Tensor):
    """The backward kernel (`csrc/lbs.cu` `romp_skinning_bwd_f32`) for CUDA
    tensors, `skinning_bwd_plain` for CPU tensors: (dA16, dv), through the
    custom op `romp_tpu_torch::skinning_bwd`. Where `skinning_bwd_plan`
    splits V into segments, dA16 is summed over them in a second kernel,
    in a fixed order: no float atomics, so a step's result does not depend
    on the schedule.

    `skinning_backward.launches` counts kernel launches (the segment
    kernel with its sum kernel is one launch)."""
    return torch.ops.romp_tpu_torch.skinning_bwd(a16, weights, v_posed, g)


skinning_backward.launches = 0


def skinning(a16: torch.Tensor, weights: torch.Tensor,
             v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning: the CUDA kernel for CUDA tensors, `skinning_plain` for CPU
    tensors, through the custom op `romp_tpu_torch::skinning`. a16:
    (B, 16, 24); weights: (V, 24); v_posed: (B, 3, V), f32. Differentiable
    in a16 and v_posed (`skinning_backward`); the weights get no gradient.

    `skinning.launches` counts forward kernel launches.
    """
    return torch.ops.romp_tpu_torch.skinning(a16, weights, v_posed)


skinning.launches = 0
