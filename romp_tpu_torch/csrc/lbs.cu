// Linear-blend skinning, forward, f32 result, on Hopper's tensor cores
// (sm_90a).
//
// Replaces romp_tpu/ops/pallas_lbs.py::skinning_pallas (_skinning_kernel):
//   T16[b] = A16[b] . W^T                          (16 x V per person)
//   verts[b, m, v] = sum_n T16[b, 4m+n, v] * vpos[b, n, v] + T16[b, 4m+3, v]
// As on the TPU, the (N, 16, V) transform block never reaches device memory:
// it lives in the MMAs' accumulators and is applied there.
//
// What bounds it (H100 SXM, chip_smoke.py phase 3): at N = 4096 persons and
// V = 6890 it reads 339 MB of v_posed and writes 339 MB of verts, 0.204 ms
// at 3.35 TB/s. The 12 x 24 product is 16.2 GFLOP: 0.243 ms on the CUDA
// cores at 67 TFLOP/s, above the bytes bound, so a CUDA-core design cannot
// reach it. Here the product runs on the tensor cores in split TF32 (three
// products, 0.099 ms at 495 TFLOP/s), and bytes bind. Measured on an H100
// 80GB HBM3 at 700 W: 0.365 ms, 56% of the bytes bound; the v_posed
// copies, the MMAs and the split-and-apply instructions add up more than
// they overlap (utils/kernel_breakdown.py, PERF.md).
//
// Design:
// - The product is mma.sync.m16n8k8 TF32 with f32 accumulators, with each
//   operand split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) and
//   three products per step (lo.hi + hi.lo + hi.hi): 1e-7 of max|ref|,
//   where one TF32 product misses the 1e-4 bar. K = 24 joints is three k
//   steps.
// - M is 16 vertices, N is 8 transform rows: rows 4m+0..3 of two persons.
//   A thread's accumulators then hold two of the four rows that one output
//   coordinate combines (even threads the x and y coefficients, odd ones z
//   and the translation), for its vertex g and g+8; it forms its half of
//   T . [x y z 1], and one __shfl_xor_sync with its neighbour completes
//   it. T stays in registers.
// - The W tile (each warp's 32 vertices x 24 joints, split) is loaded once
//   into registers (the A operand) and reused for every person of the CTA.
// - Persons go through in chunks of 4 (two pairs) through a 4-stage
//   cp.async ring that holds each chunk's A16 rows 0-11 and its v_posed
//   rows (the dominant read), so their loads overlap the MMAs. A warp
//   copies whole v_posed rows, in 16-byte copies where a row starts
//   16-byte aligned (every other row at V = 6890), else in 8- or 4-byte
//   ones. One chunk ahead, the block splits the chunk's A16 into hi / lo B
//   fragments in shared memory (one float4 per lane and k step: b0, b1 hi
//   and lo). Each warp runs a pair's six accumulator chains (3 m groups x
//   2 m16 tiles) side by side over the k steps.
// - A warp's stores cover 16 consecutive vertices of two persons per
//   output row: full 32-byte sectors along V.
// - Grid (vertex tiles of 32 x warps, person tiles). The launch plan
//   (warps per CTA, persons per CTA) comes from ops/lbs.py
//   `skinning_plan`: the card is full at N = 64 (the CLI) and at 4096.
//
// The backward (skinning_bwd_tf32_kernel + skinning_bwd_reduce_kernel)
// replaces romp_tpu/ops/pallas_lbs.py::_fused_skinning_bwd (XLA in JAX):
// for the cotangent g (N, 3, V),
//   dv[b, n, v] = sum_m T16[b, 4m+n, v] * g[b, m, v]            (n < 3)
//   dA16[b, 4m+n, j] = sum_v g[b, m, v] * vh[b, n, v] * W[v, j]  (vh = [vpos; 1])
// with rows 12-15 of dA16 zero. What bounds it: at N = 4096 it reads g and
// v_posed and writes dv, 3 x 339 MB, 0.30 ms at 3.35 TB/s; its products
// (T16's 16 rows and dA16's 12, (16 + 12) x 24 x 2 x V x N = 38 GFLOP)
// three times over at 495 TFLOP/s take 0.23 ms, so bytes bind (chip_smoke.py
// phase 3 reads both). Design: the forward's grid, launch plan, cp.async
// ring (now carrying g's rows beside v_posed's) and split A16 fragments;
// - dv: the forward's MMAs give a thread rows 4m+r of T16 (r = 0, 1 on
//   even lanes, 2, 3 on odd ones) for its vertices; it sums them against
//   g's three rows and stores dv rows 0 and 1 (even lanes) or row 2 (odd
//   lanes). T16 stays in registers.
// - dA16: per m group, a m16n8k8 product over the warp's 32 vertices with
//   M = 16 rows (4 persons of the chunk x n = 0..3), A = g[m] * vh[n]
//   formed from shared memory and split in registers, B = W (vertex x
//   joint, 3 n tiles), split once per CTA in registers; three products.
//   The warps' sums meet in shared memory and are added in a fixed order,
//   one partial per vertex tile and person goes to device memory, and a
//   second small kernel adds the tiles' partials in order: no float
//   atomics, so the result does not depend on the schedule.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3): 1.26 ms
// of device time at N = 4096, 4.1x the bytes bound, 0.19 ms at the train
// step's N = 512. A simple first design: 198 registers leave one CTA of 8
// warps an SM, and each chunk of 4 persons meets in shared memory for
// its dA16 sum, so latency is poorly hidden (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kJ = 24;                 // SMPL joints
constexpr int kARow = 12 * kJ;         // rows 0-11 of A16 (the apply's)
constexpr int kAStride = 16 * kJ;      // floats between persons of a16
constexpr int kChunk = 4;              // persons per pipeline step
constexpr int kStages = 4;             // cp.async ring depth
constexpr int kWarpVerts = 32;         // vertices per warp: two m16 tiles
constexpr int kMaxWarps = 8;
constexpr int kFrag = 2 * 3 * 3 * 32;  // B fragments a chunk (pair, m, k, lane)
constexpr int kMaxSmem = 232448;
// Measurement builds only (utils/kernel_breakdown.py): -DROMP_LBS_SKIP=mask
// leaves out the MMAs (1), the v_posed copies (2) or the stores (4), so
// that the time of what is left can be read. The results are then wrong.
#ifndef ROMP_LBS_SKIP
#define ROMP_LBS_SKIP 0
#endif
constexpr int kSkip = ROMP_LBS_SKIP;

__host__ __device__ constexpr int stage_floats(int vt) {
  return kChunk * kARow + kChunk * 3 * (vt + 8);
}

int smem_bytes(int warps) {
  return kStages * stage_floats(warps * kWarpVerts) * 4 + 2 * kFrag * 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kBytes global -> shared, of which the first n come from src and the rest
// are zero (n = 0: src is not read)
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int n) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative, both exact in TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One row of v_posed (vt floats from src, of which n exist) -> dst, in
// copies of kV floats by the lanes of one warp; zero past n.
template <int kV>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n,
                                         int vt, int lane) {
  for (int e = lane * kV; e < vt; e += 32 * kV) {
    const int bytes = max(0, min(kV, n - e)) * 4;
    cp_async<4 * kV>(smem_addr(dst + e), src + (bytes ? e : 0), bytes);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
skinning_tf32_kernel(const float* __restrict__ a16, const float* __restrict__ w,
                     const float* __restrict__ vpos, float* __restrict__ out,
                     int n, int v_count, int persons_per_cta) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x / 32;
  const int vt = warps * kWarpVerts;
  const int vrow = vt + 8;   // padded: conflict-free v_posed reads
  const int sfl = stage_floats(vt);
  float4* frag = smem4;      // [2][kFrag]
  float* stages = reinterpret_cast<float*>(smem4 + 2 * kFrag);
  const int v0 = blockIdx.x * vt;
  const int p_begin = blockIdx.y * persons_per_cta;
  const int p_end = min(n, p_begin + persons_per_cta);
  const int nchunks = (p_end - p_begin + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  // A operand: W rows of this warp's 32 vertices, split, for every person.
  // a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3 (g+8, t+4)
  uint32_t whi[2][3][4], wlo[2][3][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = v0 + warp * kWarpVerts + mt * 16 + g + (r & 1) * 8;
        const int j = ks * 8 + t + (r >> 1) * 4;
        const float x = v < v_count ? __ldg(w + (size_t)v * kJ + j) : 0.f;
        split(x, whi[mt][ks][r], wlo[mt][ks][r]);
      }
    }
  }

  auto load_chunk = [&](int c) {
    float* st = stages + (c % kStages) * sfl;
    const int pc = p_begin + c * kChunk;
    for (int i = threadIdx.x; i < kChunk * kARow / 4; i += blockDim.x) {
      const int q = i / (kARow / 4);
      const int e = (i - q * (kARow / 4)) * 4;
      const bool ok = pc + q < p_end;
      cp_async<16>(smem_addr(st + q * kARow + e),
                   ok ? a16 + (size_t)(pc + q) * kAStride + e : a16,
                   ok ? 16 : 0);
    }
    // v_posed: a warp a row (person, coordinate), in 16-byte copies where
    // the row starts 16-byte aligned (every other row when V % 4 == 2)
    for (int row = warp; row < kChunk * 3 && !(kSkip & 2); row += warps) {
      const int p = pc + row / 3;
      const int nv = p < p_end ? min(vt, v_count - v0) : 0;
      const float* src =
          vpos + ((size_t)min(p, n - 1) * 3 + row % 3) * v_count + v0;
      float* dst = st + kChunk * kARow + row * vrow;
      const uintptr_t al = reinterpret_cast<uintptr_t>(src);
      if (al % 16 == 0) {
        copy_row<4>(dst, src, nv, vt, lane);
      } else if (al % 8 == 0) {
        copy_row<2>(dst, src, nv, vt, lane);
      } else {
        copy_row<1>(dst, src, nv, vt, lane);
      }
    }
  };

  // A16 rows of chunk c -> B fragments, split: b0 (k t, n g), b1 (k t+4,
  // n g); column n = 4 * person-of-pair + row-in-m-group
  auto split_chunk = [&](int c) {
    const float* ar = stages + (c % kStages) * sfl;
    float4* fr = frag + (c & 1) * kFrag;
    for (int i = threadIdx.x; i < kFrag; i += blockDim.x) {
      const int ln = i & 31;
      const int ks = (i >> 5) % 3;
      const int m = (i / 96) % 3;
      const int q = i / 288;
      const int gg = ln >> 2;
      const float* src = ar + (2 * q + (gg >> 2)) * kARow +
                         (4 * m + (gg & 3)) * kJ + ks * 8 + (ln & 3);
      uint32_t h0, l0, h1, l1;
      split(src[0], h0, l0);
      split(src[4], h1, l1);
      fr[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(l0), __uint_as_float(l1));
    }
  };

  auto compute = [&](int c) {
    const float4* fr = frag + (c & 1) * kFrag;
    const float* vs = stages + (c % kStages) * sfl + kChunk * kARow;
    const bool odd = t & 1;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int pl = 2 * q + (t >> 1);   // the person whose rows t holds
      const int person = p_begin + c * kChunk + pl;
      // even t: the x and y coefficients; odd t: z and the translation
      float va[2][2], vb[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* row =
              vs + pl * 3 * vrow + warp * kWarpVerts + mt * 16 + g + 8 * h;
          va[mt][h] = odd ? row[2 * vrow] : row[0];
          vb[mt][h] = odd ? 1.f : row[vrow];
        }
      }
      // the three m groups' accumulators together: six independent chains
      float acc3[3][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float4 b = fr[((q * 3 + m) * 3 + ks) * 32 + lane];
          const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
          const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (kSkip & 1) {
              acc3[m][mt][ks] += b.x;
              continue;
            }
            mma_tf32(acc3[m][mt], wlo[mt][ks], bh0, bh1);
            mma_tf32(acc3[m][mt], whi[mt][ks], bl0, bl1);
            mma_tf32(acc3[m][mt], whi[mt][ks], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float (&acc)[2][4] = acc3[m];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // acc 0, 1: rows 2t, 2t+1 of the pair's 8 at vertex g; 2, 3 at g+8
          const float pg = acc[mt][0] * va[mt][0] + acc[mt][1] * vb[mt][0];
          const float pg8 = acc[mt][2] * va[mt][1] + acc[mt][3] * vb[mt][1];
          // even t finishes vertex g, odd t vertex g+8
          const float other = __shfl_xor_sync(0xffffffffu, odd ? pg : pg8, 1);
          const int v = v0 + warp * kWarpVerts + mt * 16 + g + (odd ? 8 : 0);
          // (a build without stores keeps one that never happens)
          if (person < p_end && v < v_count &&
              (!(kSkip & 4) || other == 1.2345f)) {
            out[((size_t)person * 3 + m) * v_count + v] =
                (odd ? pg8 : pg) + other;
          }
        }
      }
    }
  };

  // one group committed per chunk slot, empty past the last chunk
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_commit();
  }
  cp_wait<kStages - 2>();      // chunk 0 is in
  __syncthreads();
  split_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<kStages - 3>();    // chunk c + 1 is in
    // chunk c's fragments and chunk c + 1's stage are visible; chunk
    // c - 1's stage and fragments are free
    __syncthreads();
    if (c + kStages - 1 < nchunks) load_chunk(c + kStages - 1);
    cp_commit();
    if (c + 1 < nchunks) split_chunk(c + 1);
    compute(c);
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------- backward

constexpr int kBwdStages = 3;          // ring depth of the backward
constexpr int kDaFloats = kChunk * 12 * kJ;   // a chunk's dA16 rows 0-11

__host__ __device__ constexpr int bwd_stage_floats(int vt) {
  return kChunk * kARow + 2 * kChunk * 3 * (vt + 8);   // A16, vpos, g
}

int bwd_smem_bytes(int warps) {
  return 2 * kFrag * 16 + kBwdStages * bwd_stage_floats(warps * kWarpVerts) * 4 +
         warps * kDaFloats * 4;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
skinning_bwd_tf32_kernel(const float* __restrict__ a16,
                         const float* __restrict__ w,
                         const float* __restrict__ vpos,
                         const float* __restrict__ gin,
                         float* __restrict__ dv_out,
                         float* __restrict__ partial, int n, int v_count,
                         int persons_per_cta) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x / 32;
  const int vt = warps * kWarpVerts;
  const int vrow = vt + 8;
  const int sfl = bwd_stage_floats(vt);
  float4* frag = smem4;      // [2][kFrag]
  float* stages = reinterpret_cast<float*>(smem4 + 2 * kFrag);
  float* red = stages + kBwdStages * sfl;   // [warps][kDaFloats]
  const int v0 = blockIdx.x * vt;
  const int p_begin = blockIdx.y * persons_per_cta;
  const int p_end = min(n, p_begin + persons_per_cta);
  const int nchunks = (p_end - p_begin + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int vw = warp * kWarpVerts;   // the warp's first vertex in the tile

  // W as the A operand of the T16 recompute (the forward's fragments)
  uint32_t whi[2][3][4], wlo[2][3][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = v0 + vw + mt * 16 + g + (r & 1) * 8;
        const int j = ks * 8 + t + (r >> 1) * 4;
        const float x = v < v_count ? __ldg(w + (size_t)v * kJ + j) : 0.f;
        split(x, whi[mt][ks][r], wlo[mt][ks][r]);
      }
    }
  }
  // W as the B operand of dA16: b0 (k = vertex t, n = joint g), b1 (k t+4)
  uint32_t wbhi[4][3][2], wblo[4][3][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = v0 + vw + ks * 8 + t + r * 4;
        const float x =
            v < v_count ? __ldg(w + (size_t)v * kJ + nt * 8 + g) : 0.f;
        split(x, wbhi[ks][nt][r], wblo[ks][nt][r]);
      }
    }
  }

  auto load_chunk = [&](int c) {
    float* st = stages + (c % kBwdStages) * sfl;
    const int pc = p_begin + c * kChunk;
    for (int i = threadIdx.x; i < kChunk * kARow / 4; i += blockDim.x) {
      const int q = i / (kARow / 4);
      const int e = (i - q * (kARow / 4)) * 4;
      const bool ok = pc + q < p_end;
      cp_async<16>(smem_addr(st + q * kARow + e),
                   ok ? a16 + (size_t)(pc + q) * kAStride + e : a16,
                   ok ? 16 : 0);
    }
    // rows 0-11: v_posed (person, coordinate); rows 12-23: g
    for (int row = warp; row < 2 * kChunk * 3; row += warps) {
      const int pr = row % (kChunk * 3);
      const int p = pc + pr / 3;
      const int nv = p < p_end ? min(vt, v_count - v0) : 0;
      const float* src = (row < kChunk * 3 ? vpos : gin) +
                         ((size_t)min(p, n - 1) * 3 + pr % 3) * v_count + v0;
      float* dst = st + kChunk * kARow + row * vrow;
      const uintptr_t al = reinterpret_cast<uintptr_t>(src);
      if (al % 16 == 0) {
        copy_row<4>(dst, src, nv, vt, lane);
      } else if (al % 8 == 0) {
        copy_row<2>(dst, src, nv, vt, lane);
      } else {
        copy_row<1>(dst, src, nv, vt, lane);
      }
    }
  };

  // the forward's split of A16 rows into B fragments
  auto split_chunk = [&](int c) {
    const float* ar = stages + (c % kBwdStages) * sfl;
    float4* fr = frag + (c & 1) * kFrag;
    for (int i = threadIdx.x; i < kFrag; i += blockDim.x) {
      const int ln = i & 31;
      const int ks = (i >> 5) % 3;
      const int m = (i / 96) % 3;
      const int q = i / 288;
      const int gg = ln >> 2;
      const float* src = ar + (2 * q + (gg >> 2)) * kARow +
                         (4 * m + (gg & 3)) * kJ + ks * 8 + (ln & 3);
      uint32_t h0, l0, h1, l1;
      split(src[0], h0, l0);
      split(src[4], h1, l1);
      fr[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(l0), __uint_as_float(l1));
    }
  };

  auto compute_dv = [&](int c) {
    const float4* fr = frag + (c & 1) * kFrag;
    const float* st = stages + (c % kBwdStages) * sfl + kChunk * kARow;
    const bool odd = t & 1;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int pl = 2 * q + (t >> 1);   // the person whose rows t holds
      const int person = p_begin + c * kChunk + pl;
      const float* gs = st + (kChunk * 3 + pl * 3) * vrow + vw;
      float acc3[3][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float4 b = fr[((q * 3 + m) * 3 + ks) * 32 + lane];
          const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
          const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc3[m][mt], wlo[mt][ks], bh0, bh1);
            mma_tf32(acc3[m][mt], whi[mt][ks], bl0, bl1);
            mma_tf32(acc3[m][mt], whi[mt][ks], bh0, bh1);
          }
        }
      }
      if (person >= p_end) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int vl = mt * 16 + g + 8 * h;
          const int v = v0 + vw + vl;
          if (v >= v_count) continue;
          const float g0 = gs[vl], g1 = gs[vrow + vl], g2 = gs[2 * vrow + vl];
          // rows r0 = 2 (t & 1) and r0 + 1 of T16 at this vertex
          const float s0 = acc3[0][mt][2 * h] * g0 +
                           acc3[1][mt][2 * h] * g1 + acc3[2][mt][2 * h] * g2;
          float* dst = dv_out + (size_t)person * 3 * v_count + v;
          if (odd) {
            dst[2 * (size_t)v_count] = s0;     // row 3 is the translation
          } else {
            dst[0] = s0;
            dst[v_count] = acc3[0][mt][2 * h + 1] * g0 +
                           acc3[1][mt][2 * h + 1] * g1 +
                           acc3[2][mt][2 * h + 1] * g2;
          }
        }
      }
    }
  };

  // dA16 of the chunk's 4 persons over the warp's 32 vertices, into red
  auto compute_da = [&](int c) {
    const float* st = stages + (c % kBwdStages) * sfl + kChunk * kARow;
    float acc[3][3][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int vl = vw + ks * 8 + t;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        // a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3 (g+8,
        // t+4); row = 4 * person + n, the value g[m] * vh[n]
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = g + (r & 1) * 8;
          const int p = row >> 2, nn = row & 3;
          const int k = vl + (r >> 1) * 4;
          const float gv = st[(kChunk * 3 + p * 3 + m) * vrow + k];
          const float vh = nn == 3 ? 1.f : st[(p * 3 + nn) * vrow + k];
          split(gv * vh, ahi[r], alo[r]);
        }
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
          mma_tf32(acc[m][nt], alo, wbhi[ks][nt][0], wbhi[ks][nt][1]);
          mma_tf32(acc[m][nt], ahi, wblo[ks][nt][0], wblo[ks][nt][1]);
          mma_tf32(acc[m][nt], ahi, wbhi[ks][nt][0], wbhi[ks][nt][1]);
        }
      }
    }
    // c0 (row g, col 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1);
    // red[warp][person][4m + n][j]
    float* rw = red + warp * kDaFloats;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = g + (r >> 1) * 8;
          const int j = nt * 8 + 2 * t + (r & 1);
          rw[((row >> 2) * 12 + 4 * m + (row & 3)) * kJ + j] = acc[m][nt][r];
        }
      }
    }
  };

  // one group committed per chunk slot, empty past the last chunk
#pragma unroll
  for (int c = 0; c < kBwdStages - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_commit();
  }
  cp_wait<kBwdStages - 2>();   // chunk 0 is in
  __syncthreads();
  split_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<kBwdStages - 3>();   // chunk c + 1 is in
    // chunk c's fragments, chunk c + 1's stage and the last chunk's red
    // reads are done; chunk c - 1's stage and fragments are free
    __syncthreads();
    if (c + kBwdStages - 1 < nchunks) load_chunk(c + kBwdStages - 1);
    cp_commit();
    if (c + 1 < nchunks) split_chunk(c + 1);
    compute_dv(c);
    compute_da(c);
    __syncthreads();
    // the warps' sums in warp order: this tile's partial of each person
    const int pc = p_begin + c * kChunk;
    for (int i = threadIdx.x; i < kDaFloats; i += blockDim.x) {
      const int p = pc + i / (12 * kJ);
      float s = 0.f;
      for (int wi = 0; wi < warps; ++wi) s += red[wi * kDaFloats + i];
      if (p < p_end) {
        partial[((size_t)blockIdx.x * n + p) * (12 * kJ) + i % (12 * kJ)] = s;
      }
    }
  }
  cp_wait<0>();
}

// da16[b, r, j] = sum over the vertex tiles, in order, of partial[tile, b,
// r, j] (r < 12); rows 12-15 zero
__global__ void skinning_bwd_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ da16, int n,
                                           int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * 16 * kJ) return;
  const int b = i / (16 * kJ), e = i % (16 * kJ);
  float s = 0.f;
  if (e < 12 * kJ) {
    for (int k = 0; k < tiles; ++k) {
      s += partial[((size_t)k * n + b) * (12 * kJ) + e];
    }
  }
  da16[i] = s;
}

}  // namespace

// a16 (n, 16, j), w (v_count, j), vpos (n, 3, v_count) -> out (n, 3,
// v_count), all f32 and contiguous, a16 16-byte aligned. `warps` (1-8)
// CTA warps of 32 vertices each and `persons` (a multiple of 4) persons
// per CTA, from ops/lbs.py skinning_plan. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int romp_skinning_f32(const float* a16, const float* w,
                                 const float* vpos, float* out, int n,
                                 int v_count, int j, int warps, int persons,
                                 cudaStream_t stream) {
  if (j != kJ || n <= 0 || v_count <= 0 || warps < 1 || warps > kMaxWarps ||
      persons < kChunk || persons % kChunk != 0 ||
      (n + persons - 1) / persons > 65535 ||
      reinterpret_cast<uintptr_t>(a16) % 16 != 0 ||
      smem_bytes(warps) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const int vt = warps * kWarpVerts;
  const dim3 grid((v_count + vt - 1) / vt, (n + persons - 1) / persons);
  const int smem = smem_bytes(warps);
  // raise the kernel's shared-memory limit once per device (a host call
  // that would otherwise delay every launch)
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem_set[dev] < smem)) {
    err = cudaFuncSetAttribute(skinning_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  skinning_tf32_kernel<<<grid, warps * 32, smem, stream>>>(
      a16, w, vpos, out, n, v_count, persons);
  return (int)cudaGetLastError();
}

// The backward: a16 (n, 16, j), w (v_count, j), vpos and g (n, 3, v_count)
// -> dv (n, 3, v_count) and da16 (n, 16, j), through `partial` (tiles, n,
// 12, j) scratch, tiles = ceil(v_count / (32 warps)); the launch plan is
// the forward's. Same contract as romp_skinning_f32.
extern "C" int romp_skinning_bwd_f32(const float* a16, const float* w,
                                     const float* vpos, const float* g,
                                     float* dv, float* partial, float* da16,
                                     int n, int v_count, int j, int warps,
                                     int persons, cudaStream_t stream) {
  if (j != kJ || n <= 0 || v_count <= 0 || warps < 1 || warps > kMaxWarps ||
      persons < kChunk || persons % kChunk != 0 ||
      (n + persons - 1) / persons > 65535 ||
      reinterpret_cast<uintptr_t>(a16) % 16 != 0 ||
      bwd_smem_bytes(warps) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const int vt = warps * kWarpVerts;
  const int tiles = (v_count + vt - 1) / vt;
  const dim3 grid(tiles, (n + persons - 1) / persons);
  const int smem = bwd_smem_bytes(warps);
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem_set[dev] < smem)) {
    err = cudaFuncSetAttribute(skinning_bwd_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  skinning_bwd_tf32_kernel<<<grid, warps * 32, smem, stream>>>(
      a16, w, vpos, g, dv, partial, n, v_count, persons);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = n * 16 * kJ;
  skinning_bwd_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, da16, n, tiles);
  return (int)cudaGetLastError();
}
