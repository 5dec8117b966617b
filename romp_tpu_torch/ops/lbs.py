"""Linear-blend skinning: the hand-written CUDA kernel and its plain twin.

Counterpart of `romp_tpu/ops/pallas_lbs.py`. The kernel
(`romp_tpu_torch/csrc/lbs.cu`) computes, per person b and vertex v,

    T16 = A16[b] . W^T
    verts[b, m, v] = sum_n T16[4m+n, v] * v_posed[b, n, v] + T16[4m+3, v]

without ever writing the (B, 16, V) transform block, on the tensor cores
in split TF32 (`tf32_round`, `split_tf32_matmul` model its arithmetic).
`skinning_plan` picks the kernel's launch. Forward only: the analytic
backward of `pallas_lbs.py:113-126` comes with the training slice.
"""
from __future__ import annotations

from typing import NamedTuple

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


def skinning(a16: torch.Tensor, weights: torch.Tensor,
             v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning: the CUDA kernel for CUDA tensors, `skinning_plain` for CPU
    tensors. a16: (B, 16, 24); weights: (V, 24); v_posed: (B, 3, V), f32.
    The kernel is forward only: it raises under grad mode when an operand
    requires grad.

    `skinning.launches` counts kernel launches.
    """
    if a16.device.type == "cpu":
        return skinning_plain(a16, weights, v_posed)
    if a16.dim() != 3 or a16.device.type != "cuda":
        raise ValueError(f"skinning: a16 must be a (B, 16, 24) CUDA tensor, "
                         f"got {tuple(a16.shape)} on {a16.device}")
    _build.check_no_grad("skinning", a16, weights, v_posed)
    B, V = a16.shape[0], weights.shape[0]
    for name, t, shape in (("a16", a16, (B, 16, 24)),
                           ("weights", weights, (V, 24)),
                           ("v_posed", v_posed, (B, 3, V))):
        _build.check_operand("skinning", name, t, torch.float32, shape,
                             a16.device)
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


skinning.launches = 0
