// Linear-blend skinning, forward and backward, f32 results, on Hopper's
// tensor cores (sm_90a).
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
// The backward (skinning_bwd_segment_kernel + skinning_bwd_sum_kernel)
// replaces romp_tpu/ops/pallas_lbs.py::_fused_skinning_bwd (XLA in JAX):
// for the cotangent g (N, 3, V),
//   dv[b, n, v] = sum_m T16[b, 4m+n, v] * g[b, m, v]            (n < 3)
//   dA16[b, 4m+n, j] = sum_v g[b, m, v] * vh[b, n, v] * W[v, j]  (vh = [vpos; 1])
// with rows 12-15 of dA16 zero. What bounds it: at N = 4096 it reads g and
// v_posed and writes dv, 3 x 339 MB, 0.307 ms at 3.35 TB/s; its products
// (T16's 16 rows and dA16's 12, 38 GFLOP) three times over at 495 TFLOP/s
// take 0.23 ms, so bytes bind on paper (chip_smoke.py phase 3 reads both).
// But mma.sync reaches about half that TF32 rate: the 216 MMAs a warp
// issues for 4 persons x 32 vertices hold the tensor cores about 0.3 ms at
// N = 4096 (a build without them is that much faster).
// Design:
// - A CTA of 8 warps owns 16 persons (4 quads) and one segment of V, and
//   streams it in stages of 64 vertices through a 2-stage cp.async ring of
//   the persons' v_posed and g rows, XOR-swizzled by row so that the reads
//   below hit 32 banks. A quad's two warps take a stage's two 32-vertex
//   halves. The copies are 16-byte where a row starts 16-byte aligned
//   (every other row at V = 6890), else 8- or 4-byte: a TMA tensor map or
//   cp.async.bulk wants 16-byte row strides, which (N, 3, 6890) f32 lacks.
// - W's 64 x 24 tile of a stage is fetched into registers one stage ahead
//   by 192 threads and split once per CTA into shared memory, in both
//   fragment layouts (T16's A, dA16's B), hi and lo; no W is held in
//   registers.
// - dv: T16 of a person pair at the warp's 32 vertices by the forward's
//   m16n8k8 products (W as A; A16, split once per CTA into shared memory,
//   as B), summed against g's rows in registers and stored.
// - dA16: per m group, M = 16 rows (the quad's 4 persons x n) over the
//   warp's vertices, A = g[m] * vh[n] formed and split in registers, B = W;
//   the 36 sums stay in registers over the whole segment. At its end a
//   quad's two warps meet once in shared memory, in a fixed order, and the
//   first stores dA16 (one segment) or the segment's partial, which a small
//   kernel adds over the segments in order: no float atomics, so the
//   result does not depend on the schedule.
// - ops/lbs.py `skinning_bwd_plan` cuts V into segments only as far as two
//   CTAs on each of 132 SMs ask: one at N = 4096 (no partials), 8 at 512.
// - 124 registers, no spills, 110,592 bytes of shared memory: two CTAs an
//   SM. TF32 rounding by two integer instructions (tf32_rna): the
//   compiler's cvt.rna.tf32.f32 sequence took 5% of the time.
// - Split TF32 on mma.sync, not wgmma: a wgmma version (m64n24k8; T16 with
//   both operands and dA16 with B from shared memory) gave the same
//   results 1.3x slower, its accumulators each a chain of dependent
//   products behind warpgroup-wide waits. Other variants measured slower
//   too: T16 of 8 persons a warp without the translation rows (a quarter
//   fewer T16 MMAs, but spills or rolled loops), both pairs' T16 at once
//   (spills), L2 prefetch of the rows two stages ahead, and half the
//   warps running the dA16 part first.
// Measured on an H100 80GB HBM3 at 700 W (utils/kernel_breakdown.py, in one
// call beside the previous design): 0.890-0.896 ms of device time at
// N = 4096 (before: 1.223-1.233), 34% of the bytes bound; 0.130-0.131 ms at
// the train step's N = 512 (0.172), 30%. The MMAs, the copies and the
// operand work still add up more than they overlap: 16 warps an SM at 124
// registers leave no room to pipeline a warp's loads under its MMAs
// (PERF.md).
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

constexpr int kBwdQuads = 4;                   // warp pairs, 4 persons each
constexpr int kBwdWarps = 2 * kBwdQuads;       // a quad's two vertex halves
constexpr int kBwdPersons = 4 * kBwdQuads;     // persons per CTA
constexpr int kSub = 2 * kWarpVerts;           // vertices per ring stage
constexpr int kBwdRows = 2 * kBwdPersons * 3;  // v_posed rows, then g rows
constexpr int kBwdStage = kBwdRows * kSub;     // floats of a ring stage
constexpr int kBwdRing = 2;                    // ring stages
// split fragments in shared memory, float4 each: A16 as the B operand of
// T16 (quad, pair, m, k step, lane); W as the A operand of T16 (m16 tile,
// k step, lane; hi and lo); W as the B operand of dA16 (8 vertices, n
// tile, lane)
constexpr int kA16Frag = kBwdQuads * 2 * 3 * 3 * 32;
constexpr int kWaFrag = (kSub / 16) * 3 * 32 * 2;
constexpr int kWbFrag = (kSub / 8) * 3 * 32;
constexpr int kWCells = kSub * kJ / 8;         // W's 8-value split cells
constexpr int kDaRegs = 3 * 3 * 4;             // a warp's dA16 accumulators
// Measurement builds only (utils/kernel_breakdown.py): -DROMP_LBS_BWD_SKIP=
// mask leaves out the MMAs (1), the g / v_posed copies (2), the dA16
// meeting of a quad's two warps with the partial stores (4), the sum
// kernel (8), the dv stores (16), the W split into shared memory (32),
// the dv part (64: T16's operands, MMAs and the sums against g) or the
// dA16 part (128: its operands and MMAs). The results are then wrong.
#ifndef ROMP_LBS_BWD_SKIP
#define ROMP_LBS_BWD_SKIP 0
#endif
constexpr int kBwdSkip = ROMP_LBS_BWD_SKIP;
// cvt.rna.tf32.f32 in two integer instructions (sm_90 has no conversion
// instruction for it: the compiler's sequence adds a test for infinities
// to each); the same result for every input, infinities and NaNs kept
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// `split` with tf32_rna
__device__ __forceinline__ void split_rna(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

constexpr int bwd_smem_bytes() {
  return (kA16Frag + kWaFrag + kWbFrag) * 16 + kBwdRing * kBwdStage * 4;
}

// the float of (row, vertex) in a ring stage: 4-float groups XORed by the
// row, so that a warp's reads of v_posed and g rows hit 32 banks
__device__ __forceinline__ int at(int row, int v) {
  return row * kSub + (v ^ ((row & 7) << 2));
}

// One row segment (kSub floats from src, of which n exist) -> dst, swizzled
// as `at`, in copies of kV floats by the lanes of one warp; zero past n.
template <int kV>
__device__ __forceinline__ void copy_row_swz(float* dst, const float* src,
                                             int n, int row, int lane) {
  for (int e = lane * kV; e < kSub; e += 32 * kV) {
    const int bytes = max(0, min(kV, n - e)) * 4;
    cp_async<4 * kV>(smem_addr(dst + at(row, e)), src + (bytes ? e : 0),
                     bytes);
  }
}

__global__ void __launch_bounds__(kBwdWarps * 32, 2)
skinning_bwd_segment_kernel(const float* __restrict__ a16,
                            const float* __restrict__ w,
                            const float* __restrict__ vpos,
                            const float* __restrict__ gin,
                            float* __restrict__ dv_out,
                            float* __restrict__ da_out, int n, int v_count,
                            int seg_verts) {
  extern __shared__ float4 smem4[];
  float4* afrag = smem4;                  // [kA16Frag]
  float4* wafrag = afrag + kA16Frag;      // [kWaFrag]
  float4* wbfrag = wafrag + kWaFrag;      // [kWbFrag]
  float* ring = reinterpret_cast<float*>(wbfrag + kWbFrag);
  const int seg = blockIdx.x;
  const int v_begin = seg * seg_verts;
  const int v_end = min(v_count, v_begin + seg_verts);
  const int nsub = (v_end - v_begin + kSub - 1) / kSub;
  const int p0 = blockIdx.y * kBwdPersons;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = warp >> 1;             // persons 4 quad .. 4 quad + 3
  const int half = warp & 1;              // vertices 32 half .. + 31
  const int g = lane >> 2;
  const int t = lane & 3;

  // A16 rows 0-11 of the CTA's persons, split, as the forward's B
  // fragments: b0 (k = joint t, n = g), b1 (joint t + 4); column n = 4 *
  // person-of-pair + row-in-m-group
  for (int i = threadIdx.x; i < kA16Frag; i += blockDim.x) {
    const int ln = i & 31;
    const int ks = (i >> 5) % 3;
    const int m = (i / 96) % 3;
    const int pair = i / 288;             // quad * 2 + pair-in-quad
    const int gg = ln >> 2;
    const int p = p0 + 2 * pair + (gg >> 2);
    float x0 = 0.f, x1 = 0.f;
    if (p < n) {
      const float* src = a16 + ((size_t)p * 16 + 4 * m + (gg & 3)) * kJ +
                         ks * 8 + (ln & 3);
      x0 = __ldg(src);
      x1 = __ldg(src + 4);
    }
    uint32_t h0, l0, h1, l1;
    split_rna(x0, h0, l0);
    split_rna(x1, h1, l1);
    afrag[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                           __uint_as_float(l0), __uint_as_float(l1));
  }

  // W of stage s, split into both fragment layouts by cells of 8 values,
  // vertices v + {0, 4, 8, 12} x joints j + {0, 4} (v % 16 < 4, j % 8 <
  // 4): a cell fills 4 float4 B fragments of dA16 and the hi and lo A
  // fragments of T16 of 2 lanes, so every store is a float4 (8 lanes a
  // store: 4 vertex offsets x 2 joint parities, at most 2-way conflicts).
  // kWCells threads fetch a cell's values into registers one stage ahead.
  const bool wcell = threadIdx.x < kWCells;
  const int wc_t = threadIdx.x & 3;                 // v % 4
  const int wc_j = 8 * ((threadIdx.x >> 4) % 3) + ((threadIdx.x >> 2) & 3);
  const int wc_v = 16 * ((threadIdx.x >> 4) / 3) + wc_t;
  float wreg[8];                                    // [v offset][joint +4]
  auto fetch_w = [&](int s) {
    if (!wcell) return;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int v = v_begin + s * kSub + wc_v + 4 * (e >> 1);
      wreg[e] = v < v_end ? __ldg(w + (size_t)v * kJ + wc_j + 4 * (e & 1))
                          : 0.f;
    }
  };
  auto put_w = [&]() {
    if (!wcell || (kBwdSkip & 32)) return;
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) split_rna(wreg[e], hi[e], lo[e]);
    // dA16's B, (k8, n tile, lane 4 (j % 8) + v % 4): (b0 hi, b1 hi, b0
    // lo, b1 lo) with b1 the vertex 4 on
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v8 = (wc_v >> 3) + (e >> 1);        // e: (v + 8, j + 4)
      const int jj = wc_j + 4 * (e & 1);
      const int r = 4 * (e >> 1);                   // wreg: v, v + 4 at e
      wbfrag[(v8 * 3 + (jj >> 3)) * 32 + (jj & 7) * 4 + wc_t] = make_float4(
          __uint_as_float(hi[r + (e & 1)]), __uint_as_float(hi[r + 2 + (e & 1)]),
          __uint_as_float(lo[r + (e & 1)]), __uint_as_float(lo[r + 2 + (e & 1)]));
    }
    // T16's A, (m16 tile, k step, lane 4 (v % 8) + j % 4): a0 (v, j), a1
    // (v + 8, j), a2 (v, j + 4), a3 (v + 8, j + 4); the hi fragments,
    // then the lo ones
#pragma unroll
    for (int e = 0; e < 2; ++e) {                   // vertex v + 4 e
      const int ia = ((wc_v >> 4) * 3 + (wc_j >> 3)) * 32 +
                     ((wc_v + 4 * e) & 7) * 4 + (wc_j & 3);
      const int r = 2 * e;
      wafrag[ia] = make_float4(
          __uint_as_float(hi[r]), __uint_as_float(hi[r + 4]),
          __uint_as_float(hi[r + 1]), __uint_as_float(hi[r + 5]));
      wafrag[kWaFrag / 2 + ia] = make_float4(
          __uint_as_float(lo[r]), __uint_as_float(lo[r + 4]),
          __uint_as_float(lo[r + 1]), __uint_as_float(lo[r + 5]));
    }
  };

  // rows 0-47: v_posed (person, coordinate); rows 48-95: g; a warp a row
  auto load_rows = [&](int s) {
    float* st = ring + (s % kBwdRing) * kBwdStage;
    const int vs = v_begin + s * kSub;
    const int nv = min(kSub, v_end - vs);
    for (int row = warp; row < kBwdRows && !(kBwdSkip & 2);
         row += kBwdWarps) {
      const int pr = row % (kBwdPersons * 3);
      const int p = p0 + pr / 3;
      const float* src = (row < kBwdPersons * 3 ? vpos : gin) +
                         ((size_t)min(p, n - 1) * 3 + pr % 3) * v_count + vs;
      const int nr = p < n ? nv : 0;
      // 16-byte copies where the row starts 16-byte aligned (every other
      // row when V % 4 == 2), else 8- or 4-byte ones
      const uintptr_t al = reinterpret_cast<uintptr_t>(src);
      if (al % 16 == 0) {
        copy_row_swz<4>(st, src, nr, row, lane);
      } else if (al % 8 == 0) {
        copy_row_swz<2>(st, src, nr, row, lane);
      } else {
        copy_row_swz<1>(st, src, nr, row, lane);
      }
    }
  };

  // dA16 of the quad's 4 persons over the warp's vertices: rows 4 person
  // + n of m group m (M), joints (N, 3 tiles); c0 (row g, joint 2t), c1
  // (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
  float da[3][3][4] = {};
  const int vh0 = half * kWarpVerts;      // the warp's first vertex in a stage

  // dv: T16 rows 4m + 2 (t & 1) and + 1 of person 2 pair + (t >> 1) of
  // the quad at the warp's vertices g, g + 8 of each m16 tile (the
  // forward's MMAs), summed against g's three rows
  auto t16_part = [&](const float* st, int vs) {
    if (kBwdSkip & 64) return;
    // (loops left rolled where unrolling would lift the register use past
    // the 128 that two CTAs an SM allow)
#pragma unroll 1
    for (int pair = 0; pair < 2; ++pair) {
      float acc[3][2][4] = {};
#pragma unroll 1
      for (int ks = 0; ks < 3; ++ks) {
        uint32_t whi[2][4], wlo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int ia = ((2 * half + mt) * 3 + ks) * 32 + lane;
          const float4 h4 = wafrag[ia], l4 = wafrag[kWaFrag / 2 + ia];
          whi[mt][0] = __float_as_uint(h4.x);
          whi[mt][1] = __float_as_uint(h4.y);
          whi[mt][2] = __float_as_uint(h4.z);
          whi[mt][3] = __float_as_uint(h4.w);
          wlo[mt][0] = __float_as_uint(l4.x);
          wlo[mt][1] = __float_as_uint(l4.y);
          wlo[mt][2] = __float_as_uint(l4.z);
          wlo[mt][3] = __float_as_uint(l4.w);
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float4 b =
              afrag[(((quad * 2 + pair) * 3 + m) * 3 + ks) * 32 + lane];
          const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
          const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (kBwdSkip & 1) {
              acc[m][mt][0] += b.x + __uint_as_float(whi[mt][0] ^ wlo[mt][3]);
              continue;
            }
            mma_tf32(acc[m][mt], wlo[mt], bh0, bh1);
            mma_tf32(acc[m][mt], whi[mt], bl0, bl1);
            mma_tf32(acc[m][mt], whi[mt], bh0, bh1);
          }
        }
      }
      const int pc = 4 * quad + 2 * pair + (t >> 1);   // person in the CTA
      const int person = p0 + pc;
      if (person >= n) continue;
      // even t: dv rows 0 and 1; odd t: row 2 (its second T16 row, 3, is
      // the translation)
      float* dst = dv_out + ((size_t)person * 3 + ((t & 1) << 1)) * v_count;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int vl = vh0 + mt * 16 + g + 8 * h;
          const int v = vs + vl;
          const float g0 = st[at(kBwdPersons * 3 + 3 * pc, vl)];
          const float g1 = st[at(kBwdPersons * 3 + 3 * pc + 1, vl)];
          const float g2 = st[at(kBwdPersons * 3 + 3 * pc + 2, vl)];
          const float s0 = acc[0][mt][2 * h] * g0 + acc[1][mt][2 * h] * g1 +
                           acc[2][mt][2 * h] * g2;
          const float s1 = acc[0][mt][2 * h + 1] * g0 +
                           acc[1][mt][2 * h + 1] * g1 +
                           acc[2][mt][2 * h + 1] * g2;
          // (a build without dv stores keeps one that never happens)
          const bool ok = v < v_end && (!(kBwdSkip & 16) || s0 == 1.2345f);
          if (ok) dst[v] = s0;
          if (ok && !(t & 1)) dst[v_count + v] = s1;
        }
      }
    }
  };

  // dA16: per m group, a m16n8k8 product over the warp's 32 vertices (4 k
  // steps of 8), A = g[m] * vh[n] formed and split in registers, B = W from
  // the split fragments; the sums stay in registers
  auto da16_part = [&](const float* st) {
    if (kBwdSkip & 128) return;
#pragma unroll 1
    for (int ks = 0; ks < 4; ++ks) {
      const int kb = vh0 + ks * 8;
      float4 wbf[3];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        wbf[nt] = wbfrag[(((vh0 >> 3) + ks) * 3 + nt) * 32 + lane];
      }
      // a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3 (g+8,
      // t+4); row = 4 * person + n
      float vh[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + (r & 1) * 8;
        const int nn = row & 3;
        const int k = kb + t + (r >> 1) * 4;
        vh[r] = nn == 3 ? 1.f : st[at(3 * (4 * quad + (row >> 2)) + nn, k)];
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = g + (r & 1) * 8;
          const int k = kb + t + (r >> 1) * 4;
          const float gv =
              st[at(kBwdPersons * 3 + 3 * (4 * quad + (row >> 2)) + m, k)];
          split_rna(gv * vh[r], ahi[r], alo[r]);
        }
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
          const uint32_t bh0 = __float_as_uint(wbf[nt].x);
          const uint32_t bh1 = __float_as_uint(wbf[nt].y);
          const uint32_t bl0 = __float_as_uint(wbf[nt].z);
          const uint32_t bl1 = __float_as_uint(wbf[nt].w);
          if (kBwdSkip & 1) {
            da[m][nt][0] += __uint_as_float(ahi[0] ^ alo[1] ^ bh0 ^ bl1);
            continue;
          }
          mma_tf32(da[m][nt], alo, bh0, bh1);
          mma_tf32(da[m][nt], ahi, bl0, bl1);
          mma_tf32(da[m][nt], ahi, bh0, bh1);
        }
      }
    }
  };

  fetch_w(0);
  load_rows(0);
  cp_commit();
  for (int s = 0; s < nsub; ++s) {
    // stage s - 1's products are done: the W fragments and its ring stage
    // are free (and, at s = 0, the A16 fragments are visible)
    __syncthreads();
    put_w();
    if (s + 1 < nsub) load_rows(s + 1);
    cp_commit();
    cp_wait<1>();        // this thread's copies of stage s are in
    __syncthreads();     // everyone's, and the W fragments, are visible
    const float* st = ring + (s % kBwdRing) * kBwdStage;
    t16_part(st, v_begin + s * kSub);
    // the next stage's W between the parts (where fewer registers live)
    if (s + 1 < nsub) fetch_w(s + 1);
    da16_part(st);
  }
  cp_wait<0>();

  // the segment's end: a quad's second warp hands its sums to the first
  // through shared memory, which adds them in that order and stores dA16
  // rows 0-11 (one segment) or the segment's partial
  const bool whole = gridDim.x == 1;
  if (kBwdSkip & 4) {
    // (a build without the meeting keeps stores that never happen)
#pragma unroll
    for (int i = 0; i < kDaRegs; ++i) {
      if ((&da[0][0][0])[i] == 1.2345f) da_out[threadIdx.x] = 1.f;
    }
    return;
  }
  __syncthreads();       // the last stage's reads are done
  float* red = ring + quad * kDaRegs * 32;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < kDaRegs; ++i) red[i * 32 + lane] = (&da[0][0][0])[i];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = (m * 3 + nt) * 4 + 2 * hr;
        const int row = g + 8 * hr;
        const int person = p0 + 4 * quad + (row >> 2);
        if (person >= n) continue;
        const float2 val = make_float2(da[m][nt][2 * hr] + red[i * 32 + lane],
                                       da[m][nt][2 * hr + 1] +
                                           red[(i + 1) * 32 + lane]);
        const int r16 = 4 * m + (row & 3);
        const int j = nt * 8 + 2 * t;
        float* dst = whole ? da_out + ((size_t)person * 16 + r16) * kJ + j
                           : da_out + (((size_t)seg * n + person) * 12 + r16) *
                                          kJ + j;
        *reinterpret_cast<float2*>(dst) = val;
      }
    }
  }
  if (whole) {
    // rows 12-15 of the quad's persons are zero
    for (int e = lane; e < 4 * 4 * kJ; e += 32) {
      const int person = p0 + 4 * quad + e / (4 * kJ);
      if (person < n) {
        da_out[((size_t)person * 16 + 12) * kJ + e % (4 * kJ)] = 0.f;
      }
    }
  }
}

// da16[b, r, j] = sum over the segments, in order, of partial[seg, b, r, j]
// (r < 12); rows 12-15 zero
__global__ void skinning_bwd_sum_kernel(const float* __restrict__ partial,
                                        float* __restrict__ da16, int n,
                                        int segments) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * 16 * kJ) return;
  const int b = i / (16 * kJ), e = i % (16 * kJ);
  float s = 0.f;
  if (e < 12 * kJ) {
    for (int k = 0; k < segments; ++k) {
      s += partial[((size_t)k * n + b) * (12 * kJ) + e];
    }
  }
  da16[i] = s;
}

// the backward kernel's attributes, once per device: its dynamic shared
// memory and the largest shared-memory carveout, so two CTAs fit an SM
cudaError_t bwd_attributes() {
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  err = cudaFuncSetAttribute(skinning_bwd_segment_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bwd_smem_bytes());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(skinning_bwd_segment_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
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
// -> dv (n, 3, v_count) and da16 (n, 16, j). The launch plan is ops/lbs.py
// `skinning_bwd_plan`'s: `segments` vertex segments of `seg_verts` (a
// multiple of 64) vertices, segments = ceil(v_count / seg_verts); with
// more than one, the segments' dA16 partials go through `partial`
// (segments, n, 12, j) scratch and a second kernel adds them in order
// (`partial` may be null with one segment). Same contract as
// romp_skinning_f32.
extern "C" int romp_skinning_bwd_f32(const float* a16, const float* w,
                                     const float* vpos, const float* g,
                                     float* dv, float* partial, float* da16,
                                     int n, int v_count, int j, int seg_verts,
                                     int segments, cudaStream_t stream) {
  if (j != kJ || n <= 0 || v_count <= 0 || seg_verts <= 0 ||
      seg_verts % kSub != 0 ||
      segments != (v_count + seg_verts - 1) / seg_verts ||
      (n + kBwdPersons - 1) / kBwdPersons > 65535 ||
      (segments > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = bwd_attributes();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(segments, (n + kBwdPersons - 1) / kBwdPersons);
  skinning_bwd_segment_kernel<<<grid, kBwdWarps * 32, bwd_smem_bytes(),
                                stream>>>(a16, w, vpos, g, dv,
                                          segments > 1 ? partial : da16, n,
                                          v_count, seg_verts);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1 || (kBwdSkip & 8)) return (int)err;
  const int total = n * 16 * kJ;
  skinning_bwd_sum_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, da16, n, segments);
  return (int)cudaGetLastError();
}

// CTAs of the backward's segment kernel that fit one SM at once (the
// CUDA occupancy calculator), into *ctas; returns the cudaError_t.
extern "C" int romp_skinning_bwd_occupancy(int* ctas) {
  cudaError_t err = bwd_attributes();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, skinning_bwd_segment_kernel, kBwdWarps * 32, bwd_smem_bytes());
}
