// One conv pass of a fused chain of stride-1 HRNet BasicBlocks (inference),
// on Hopper's tensor cores (sm_90a).
//
// Replaces romp_tpu/ops/pallas_fuse.py::fused_basic_chain (_chain_kernel,
// _conv_pass). Each BasicBlock is two passes of this kernel:
//   h = relu(conv3x3(x) * scale1 + shift1)
//   y = relu(conv3x3(h) * scale2 + shift2 + x)
// with the numerics of the TPU kernel: the conv's operands (activations and
// packed weights) are bf16, rounded once with __float2bfloat16_rn by the
// kernel that writes them; products are accumulated in f32 and the folded
// BatchNorm scale/shift, residual and ReLU run in f32.
//
// Why the TPU form does not carry over: the TPU kernel holds a whole padded
// map in VMEM and chains all blocks there. The C=32 branch at 128x128 is
// 2 MB in f32, far over the 227 KB of shared memory a Hopper block can use.
// So a block is two launches and the map stays in device memory between
// them; what goes there is cut down instead (see Bytes).
//
// Design: each pass is an implicit GEMM, M = output pixels of a spatial
// tile (tile_h x 8), N = output channels (tile_n of them), K = 9 taps x C
// input channels, walked in chunks of 32 input channels (9 x 32 = 288 of
// K). Per chunk, cp.async stages in shared memory
//   A: the bf16 input tile with its 1-pixel halo, pixel-major with the 32
//      channels contiguous (NHWC), rows padded to 40 values so that the 8
//      row addresses of every ldmatrix fall in distinct banks; zero outside
//      the map and past C (cp.async's zero fill);
//   B: the chunk's rows of the packed (3C, 3C) weights, [tap][ci][co],
//      rows padded to tile_n + 8 values, zero past C.
// Two stages: the next chunk loads while the MMAs run on this one; under
// the last chunk the free stage takes the residual's f32 block instead, so
// the epilogue reads it from shared memory. Four warps (eight for the
// 32 x 8 x 64 tile) split the tile as squarely as they can (Tile::kWarpsM
// x kWarpsN) and run mma.sync.m16n8k16 (bf16 x bf16 -> f32) on fragments
// from ldmatrix (A as stored; B with .trans). The A tile is read by all 9
// taps by shifting the fragment's row addresses, so the halo is staged
// once per chunk. The epilogue applies BN, residual and ReLU in f32 and
// writes the f32 NCHW output and/or a bf16 NHWC copy for the next conv.
//
// Grid: (batch x spatial tiles, C / tile_n, ksplit). The launch plan (tile,
// N split, K split, shared memory) comes from ops/fused_chain.py
// `launch_plan`, which aims for at least 128 CTAs on the 132 SMs. With
// ksplit > 1 each CTA sums an equal share of the chunks into an f32
// workspace and `ksplit_reduce_kernel` adds the shares in a fixed order and
// runs the epilogue: no atomics, so a run is bit-equal to the next.
//
// Plans for the HRNet branch shapes (tile rows x 8 pixels x tile_n
// channels, CTAs, shared memory per CTA), at B = 1 / 2 / 64:
//   C=32,  128x128: 16x8x32, 128, 74,880 B / 32x8x32, 128, 100,480 B /
//                   32x8x32, 4096, 100,480 B
//   C=64,  64x64  : 8x8x32, 128, 62,080 B / 8x8x64, 128, 98,944 B /
//                   32x8x64 (256 threads), 1024, 137,344 B
//   C=128, 32x32  : 4x8x32, 128, 55,680 B / 8x8x32, 128, 62,080 B /
//                   32x8x64 (256 threads), 512, 137,344 B
//   C=256, 16x16  : 4x8x32 with ksplit 2, 128, 55,680 B / 4x8x32, 128,
//                   55,680 B / 16x8x64, 512, 111,744 B
//
// Bound (chip_smoke.py phase 3; H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s):
// a 4-block chain is 8 convs of 2 * 9 * C^2 * HW FLOP per image. C^2 * HW
// is the same at every branch shape, so the bound is 4.83 GFLOP /
// 989 TFLOP/s = 0.0049 ms at B = 2 and 154.6 GFLOP -> 0.156 ms at B = 64
// (operations; the bytes of x read once and y written once are 0.080 ms at
// C = 32, B = 64, and halve with each wider branch).
//
// Bytes: inside a chain conv1 writes h as bf16 NHWC only (conv2 reads it as
// a bf16 operand: bit-identical to rounding it on load), and conv2 writes y
// in f32 NCHW (the next block's residual) plus its bf16 NHWC copy (the
// next conv1's operand). Per block and element: 2 + 2 (conv1) and
// 2 + 4 + 4 + 2 (conv2) bytes, where f32 operands and outputs would
// move 20.
//
// Registers (nvcc -Xptxas -v for sm_90a, CUDA 12.8; chip_smoke.py phase 2
// prints them): conv kernel <tile_h, tile_n> <4,32> 70, <8,32> 79,
// <8,64> 120, <16,32> 103, <16,64> 166, <32,32> 136, <32,64> 166 (256
// threads); the reduce 32; the NCHW -> NHWC conversion 21 (and 4,224 bytes
// of static shared memory). No spills, no stack. The conv kernel's shared
// memory is all dynamic (the plans above).
//
// What binds it (utils/chain_plans.py --breakdown, PERF.md): at B = 64 a
// pass's MMAs, its copies and its epilogue take about as long as their sum;
// they do not hide one another.
//
// bf16 in and out (romp_basic_chain_bf16; the bf16-activation path, where
// the TPU kernel casts its bf16 input to f32 and its f32 result to bf16,
// pallas_fuse.py:145-146, 174): the conversion reads the bf16 NCHW input
// (bf16 NCHW -> bf16 NHWC, exact); block 0's residual is that bf16 input,
// widened exactly in the epilogue (prefetched as the f32 residual is, runs
// of 8 pixels, where W % 8 == 0); the inner blocks' outputs stay f32, as in the TPU kernel's
// VMEM; the last pass's epilogue rounds its f32 result to bf16 NCHW
// itself. So it equals the f32 chain on the widened input, cast to bf16,
// bit for bit (the same plan and passes). Where C is 32 or 64 and the plan
// does not split K, the bf16 chain runs chain_block_bf16.cu instead (one
// launch a block, h in shared memory; ops/fused_chain.py
// `bf16_chain_plan`); these passes serve the other shapes.
//
// Tried on the H100 against this design and not kept (no gain beyond the
// run-to-run spread, or a loss): wgmma.m64nNk16 with A from registers
// (ldmatrix) and B through a no-swizzle N-major descriptor, with the
// epilogue staged through shared memory (right at every plan; slower at
// B = 1-2, no faster at 64); a persistent grid whose cp.async ring runs
// across output tiles (twice); the next chunk's copies interleaved with
// the k steps; fragments double-buffered across k steps; 16-channel
// chunks; three stages; programmatic dependent launch of the next pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 8;       // output tile columns
constexpr int kHaloW = kTileW + 2;
constexpr int kChunk = 32;      // input channels per K chunk
constexpr int kAStride = kChunk + 8;   // bf16 values per staged pixel
constexpr int kStages = 2;
// Measurement builds only (utils/chain_plans.py --breakdown):
// -DROMP_CHAIN_SKIP=mask leaves out the copies of A (1) or B (2), or the
// epilogue with the residual's prefetch (4), so that the time of what is
// left can be read. The results of such a build are wrong.
#ifndef ROMP_CHAIN_SKIP
#define ROMP_CHAIN_SKIP 0
#endif
constexpr int kSkip = ROMP_CHAIN_SKIP;

template <int TH, int TN>
struct Tile {
  static constexpr int kHaloPix = (TH + 2) * kHaloW;
  static constexpr int kBStride = TN + 8;
  static constexpr int kAElems = kHaloPix * kAStride;
  static constexpr int kBElems = 9 * kChunk * kBStride;
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  // 4 warps; 8 for the 32 x 8 x 64 tile, whose weights then serve twice
  // the pixels of a 16-row tile. The warps split the tile 4 x 1 along
  // (M, N), or 2 x 2 (4 x 2) where N is 64 or M too short for 4 warps of
  // 16 rows: each warp's piece is as square as the tile allows, which
  // keeps its ldmatrix per MMA low
  static constexpr int kThreads = TH == 32 && TN == 64 ? 256 : 128;
  static constexpr int kWarpsN = TN >= 64 || TH * kTileW < 64 ? 2 : 1;
  static constexpr int kWarpsM = kThreads / 32 / kWarpsN;
  static constexpr int kMI = TH * kTileW / kWarpsM / 16;   // m16 per warp
  static constexpr int kNI = TN / kWarpsN / 8;             // n8 per warp
  // the residual's f32 block, [n][pixel] with rows of kM + 4 (conflict-
  // free epilogue reads), prefetched into the stage the last chunk frees
  static constexpr int kM = TH * kTileW;
  static constexpr int kRLd = kM + 4;
  static_assert(TN * kRLd * 4 <= kStageElems * 2, "residual > a stage");
  // the bf16 residual's block (block 0 of the bf16 chain), rows of kM + 8
  // values (16-byte aligned rows)
  static constexpr int kRLdB = kM + 8;
  static_assert(TN * kRLdB * 2 <= kStageElems * 2, "residual > a stage");
};

struct ConvArgs {
  const __nv_bfloat16* x;   // (B, H, W, C) bf16
  const __nv_bfloat16* w;   // (3C, 3C) bf16, w[dy*C + ci, dx*C + co]
  const float* scale;       // (C,)
  const float* shift;       // (C,)
  const float* residual;    // (B, C, H, W) f32 or null
  const __nv_bfloat16* residual_bf16;   // (B, C, H, W) bf16 or null
  float* out;               // (B, C, H, W) f32 or null
  __nv_bfloat16* out_bf16;  // (B, H, W, C) bf16 or null
  __nv_bfloat16* out_nchw_bf16;   // (B, C, H, W) bf16 or null
  float* partial;           // (ksplit, B, C, H, W) f32, or null (ksplit 1)
  int batch, C, H, W, tiles_w, tiles_hw, chunks_per_split;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero fill when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage chunk `ch` (input channels ch*32 ..) of the A halo tile and the
// weights into one shared-memory stage.
template <int TH, int TN>
__device__ __forceinline__ void load_chunk(const ConvArgs& p, uint32_t a_s,
                                           uint32_t b_s, int b, int ty0,
                                           int tx0, int n0, int ch) {
  using T = Tile<TH, TN>;
  const int c0 = ch * kChunk;
  for (int i = threadIdx.x; i < T::kHaloPix * (kChunk / 8) && !(kSkip & 1);
       i += T::kThreads) {
    const int px = i / (kChunk / 8);
    const int q = i % (kChunk / 8);
    const int gy = ty0 + px / kHaloW - 1;
    const int gx = tx0 + px % kHaloW - 1;
    const int c = c0 + q * 8;
    const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && c < p.C;
    const __nv_bfloat16* src =
        ok ? p.x + ((size_t)(b * p.H + gy) * p.W + gx) * p.C + c : p.x;
    cp_async16(a_s + (px * kAStride + q * 8) * 2, src, ok);
  }
  // B: each thread copies the same (k, 8 channels) pieces of all 9 taps,
  // whose rows differ by constant offsets
  constexpr int kPerTap = kChunk * (TN / 8);   // 16-byte pieces a tap
  static_assert(kPerTap % T::kThreads == 0, "B pieces per thread");
  const int ldw = 3 * p.C;
#pragma unroll
  for (int m = 0; m < kPerTap / T::kThreads && !(kSkip & 2); ++m) {
    const int i = threadIdx.x + m * T::kThreads;
    const int k = i / (TN / 8);
    const int q = i % (TN / 8);
    const bool ok = c0 + k < p.C && n0 + q * 8 < p.C;
    const __nv_bfloat16* row = p.w + (size_t)(c0 + k) * ldw + n0 + q * 8;
    const uint32_t dst = b_s + (k * T::kBStride + q * 8) * 2;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      cp_async16(dst + tap * kChunk * T::kBStride * 2,
                 ok ? row + (size_t)(tap / 3) * p.C * ldw + (tap % 3) * p.C
                    : p.w,
                 ok);
    }
  }
}

// Prefetch the residual's (TN channels x tile) f32 block, as runs of 4
// pixels, into r_s (Tile::kRLd floats a channel); zero outside the map.
// Only where W % 4 == 0, so that every run is 16-byte aligned.
template <int TH, int TN>
__device__ __forceinline__ void load_residual(const ConvArgs& p,
                                              uint32_t r_s, int b, int ty0,
                                              int tx0, int n0) {
  using T = Tile<TH, TN>;
  const size_t plane = (size_t)p.H * p.W;
  for (int i = threadIdx.x; i < TN * (T::kM / 4); i += T::kThreads) {
    const int nl = i / (T::kM / 4);
    const int m = (i % (T::kM / 4)) * 4;
    const int n = n0 + nl;
    const int gy = ty0 + m / kTileW;
    const int gx = tx0 + m % kTileW;
    const bool ok = n < p.C && gy < p.H && gx < p.W;
    const float* src = ok ? p.residual + ((size_t)b * p.C + n) * plane +
                                (size_t)gy * p.W + gx
                          : p.residual;
    cp_async16(r_s + (nl * T::kRLd + m) * 4, src, ok);
  }
}

// The same for a bf16 residual: runs of 8 pixels (one tile row), into r_s
// (Tile::kRLdB bf16 values a channel). Only where W % 8 == 0.
template <int TH, int TN>
__device__ __forceinline__ void load_residual_bf16(const ConvArgs& p,
                                                   uint32_t r_s, int b,
                                                   int ty0, int tx0, int n0) {
  using T = Tile<TH, TN>;
  const size_t plane = (size_t)p.H * p.W;
  for (int i = threadIdx.x; i < TN * (T::kM / 8); i += T::kThreads) {
    const int nl = i / (T::kM / 8);
    const int m = (i % (T::kM / 8)) * 8;
    const int n = n0 + nl;
    const int gy = ty0 + m / kTileW;
    const bool ok = n < p.C && gy < p.H && tx0 < p.W;
    const __nv_bfloat16* src =
        ok ? p.residual_bf16 + ((size_t)b * p.C + n) * plane +
                 (size_t)gy * p.W + tx0
           : p.residual_bf16;
    cp_async16(r_s + (nl * T::kRLdB + m) * 2, src, ok);
  }
}

template <int TH, int TN>
__global__ void __launch_bounds__(Tile<TH, TN>::kThreads)
conv3x3_bn_act_mma_kernel(const ConvArgs p) {
  using T = Tile<TH, TN>;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];

  const int b = blockIdx.x / p.tiles_hw;
  const int t = blockIdx.x % p.tiles_hw;
  const int ty0 = (t / p.tiles_w) * TH;
  const int tx0 = (t % p.tiles_w) * kTileW;
  const int n0 = blockIdx.y * TN;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the warp's first pixel and first channel
  const int wm = (warp % T::kWarpsM) * (TH * kTileW / T::kWarpsM);
  const int wn = (warp / T::kWarpsM) * (TN / T::kWarpsN);

  // Per-lane ldmatrix row offsets (in bf16 values, for tap (0, 0), k 0).
  // A: matrix q = lane / 8 holds rows (q & 1) * 8 .. + 7, k (q >> 1) * 8.
  int a_off[T::kMI];
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi) {
    const int m = wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_off[mi] = ((m / kTileW) * kHaloW + m % kTileW) * kAStride +
                (lane >> 4) * 8;
  }
  // B (.trans): matrix q holds k (q & 1) * 8 .. + 7, n (q >> 1) * 8 .. + 7.
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * T::kBStride + wn +
                    (lane >> 4) * 8;

  float acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const uint32_t s0 = smem_addr(smem);
  const int ch0 = split * p.chunks_per_split;
  const int nch = p.chunks_per_split;
  const bool prefetch = p.W % 4 == 0 && p.residual != nullptr &&
                        p.partial == nullptr && !(kSkip & 4);
  const bool prefetch_b = p.W % 8 == 0 && p.residual_bf16 != nullptr &&
                          p.partial == nullptr && !(kSkip & 4);
  load_chunk<TH, TN>(p, s0, s0 + T::kAElems * 2, b, ty0, tx0, n0, ch0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int it = 0; it < nch; ++it) {
    // the other stage: the next chunk's, or, under the last chunk, the
    // residual's block (in flight behind the MMAs)
    const uint32_t s = s0 + ((it + 1) % kStages) * T::kStageElems * 2;
    if (it + 1 < nch) {
      load_chunk<TH, TN>(p, s, s + T::kAElems * 2, b, ty0, tx0, n0,
                         ch0 + it + 1);
    } else if (prefetch) {
      load_residual<TH, TN>(p, s, b, ty0, tx0, n0);
    } else if (prefetch_b) {
      load_residual_bf16<TH, TN>(p, s, b, ty0, tx0, n0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // chunk `it` has landed
    __syncthreads();

    const uint32_t a_s = s0 + (it % kStages) * T::kStageElems * 2;
    const uint32_t b_s = a_s + T::kAElems * 2;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int a_tap = ((tap / 3) * kHaloW + tap % 3) * kAStride;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t af[T::kMI][4];
#pragma unroll
        for (int mi = 0; mi < T::kMI; ++mi) {
          ldmatrix_x4(a_s + (a_off[mi] + a_tap + kk * 16) * 2, af[mi]);
        }
#pragma unroll
        for (int nj = 0; nj < T::kNI / 2; ++nj) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              b_s + (b_off + (tap * kChunk + kk * 16) * T::kBStride +
                     nj * 16) * 2,
              bf);
#pragma unroll
          for (int mi = 0; mi < T::kMI; ++mi) {
            mma_bf16(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();   // this stage is refilled two chunks on
  }

  // Epilogue. Fragment of acc[mi][ni]: rows g and g + 8, columns 2t, 2t+1.
  // All loads (scale, shift, residual) are issued before the first store:
  // the pointers may alias as far as the compiler knows, so a load after a
  // store would wait for it.
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t plane = (size_t)p.H * p.W;
  int pix[T::kMI][2];   // pixel index in the plane, -1 outside the map
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm + mi * 16 + g + half * 8;
      const int gy = ty0 + m / kTileW;
      const int gx = tx0 + m % kTileW;
      pix[mi][half] = (gy < p.H && gx < p.W) ? gy * p.W + gx : -1;
    }
  }
  const size_t img = (size_t)b * p.C * plane;
  const float* rs = reinterpret_cast<const float*>(smem + (nch % kStages) *
                                                   T::kStageElems);
  const __nv_bfloat16* rsb = smem + (nch % kStages) * T::kStageElems;
  if (prefetch || prefetch_b) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  if (kSkip & 4) {   // keep the MMAs: ptxas drops those whose sums are dead
    float sum = 0.f;
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum += acc[mi][ni][r];
    if (sum == 1.5e-38f && p.out_bf16 != nullptr) p.out_bf16[0] = sum;
    return;
  }
  if (p.partial != nullptr) {
    float* part = p.partial + (size_t)split * p.batch * p.C * plane + img;
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int ni = 0; ni < T::kNI; ++ni) {
          const int n = n0 + wn + ni * 8 + 2 * tq;
          if (pix[mi][half] < 0 || n >= p.C) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            part[(size_t)(n + j) * plane + pix[mi][half]] =
                acc[mi][ni][half * 2 + j];
        }
    return;
  }
#pragma unroll
  for (int ni = 0; ni < T::kNI; ++ni) {
    const int n = n0 + wn + ni * 8 + 2 * tq;
    if (n >= p.C) continue;   // C % 8 == 0: n and n + 1 are both in
    const float2 sc = make_float2(p.scale[n], p.scale[n + 1]);
    const float2 sh = make_float2(p.shift[n], p.shift[n + 1]);
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* a = &acc[mi][ni][half * 2];
        a[0] = a[0] * sc.x + sh.x;
        a[1] = a[1] * sc.y + sh.y;
        if (prefetch) {
          const float* r = rs + (n - n0) * T::kRLd + wm + mi * 16 + g +
                           half * 8;
          a[0] += r[0];
          a[1] += r[T::kRLd];
        } else if (prefetch_b) {
          const __nv_bfloat16* r = rsb + (n - n0) * T::kRLdB + wm + mi * 16 +
                                   g + half * 8;
          a[0] += __bfloat162float(r[0]);
          a[1] += __bfloat162float(r[T::kRLdB]);
        } else if (p.residual != nullptr && pix[mi][half] >= 0) {
          const float* r = p.residual + img + (size_t)n * plane +
                           pix[mi][half];
          a[0] += r[0];
          a[1] += r[plane];
        } else if (p.residual_bf16 != nullptr && pix[mi][half] >= 0) {
          const __nv_bfloat16* r = p.residual_bf16 + img +
                                   (size_t)n * plane + pix[mi][half];
          a[0] += __bfloat162float(r[0]);
          a[1] += __bfloat162float(r[plane]);
        }
      }
  }
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (pix[mi][half] < 0) continue;
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * tq;
        if (n >= p.C) continue;
        const float v0 = fmaxf(acc[mi][ni][half * 2], 0.f);
        const float v1 = fmaxf(acc[mi][ni][half * 2 + 1], 0.f);
        if (p.out != nullptr) {
          float* o = p.out + img + (size_t)n * plane + pix[mi][half];
          o[0] = v0;
          o[plane] = v1;
        }
        if (p.out_bf16 != nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(
              p.out_bf16 + ((size_t)b * plane + pix[mi][half]) * p.C + n) =
              __floats2bfloat162_rn(v0, v1);
        }
        if (p.out_nchw_bf16 != nullptr) {
          __nv_bfloat16* o =
              p.out_nchw_bf16 + img + (size_t)n * plane + pix[mi][half];
          o[0] = __float2bfloat16_rn(v0);
          o[plane] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// K-split second pass: add the ksplit partial sums in order, then the same
// epilogue as above. One thread per output element, NCHW order.
__global__ void ksplit_reduce_kernel(const ConvArgs p, int ksplit) {
  const size_t plane = (size_t)p.H * p.W;
  const size_t total = (size_t)p.batch * p.C * plane;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < ksplit; ++s) a += p.partial[s * total + idx];
    const int n = (int)((idx / plane) % p.C);
    float o = a * p.scale[n] + p.shift[n];
    if (p.residual != nullptr) o += p.residual[idx];
    if (p.residual_bf16 != nullptr) o += __bfloat162float(p.residual_bf16[idx]);
    o = fmaxf(o, 0.f);
    if (p.out != nullptr) p.out[idx] = o;
    if (p.out_nchw_bf16 != nullptr) p.out_nchw_bf16[idx] = __float2bfloat16_rn(o);
    if (p.out_bf16 != nullptr) {
      const size_t b = idx / (plane * p.C);
      p.out_bf16[(b * plane + idx % plane) * p.C + n] =
          __float2bfloat16_rn(o);
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (B, C, HW) f32 or bf16 -> (B, HW, C) bf16, rounded to nearest even (exact
// from bf16): the operand of a chain's first conv. 32 x 32 tiles
// transposed through shared memory.
template <typename Tin>
__global__ void nchw_to_nhwc_bf16_kernel(const Tin* __restrict__ x,
                                         __nv_bfloat16* __restrict__ y,
                                         int C, int HW) {
  __shared__ float t[32][33];
  const int p0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const size_t b = blockIdx.z;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i;
    const int px = p0 + threadIdx.x;
    if (c < C && px < HW) {
      t[i][threadIdx.x] = to_f32(x[(b * C + c) * HW + px]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int px = p0 + i;
    const int c = c0 + threadIdx.x;
    if (px < HW && c < C) {
      y[(b * HW + px) * C + c] = __float2bfloat16_rn(t[threadIdx.x][i]);
    }
  }
}

template <int TH, int TN>
cudaError_t launch_conv(const ConvArgs& p, int ksplit, int smem_bytes,
                        cudaStream_t stream) {
  using T = Tile<TH, TN>;
  if (smem_bytes != T::kSmemBytes) return cudaErrorInvalidValue;
  auto kernel = conv3x3_bn_act_mma_kernel<TH, TN>;
  // once per instantiation and process (the attribute is per function;
  // the port runs on one device)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.batch * p.tiles_hw, p.C / TN + (p.C % TN != 0), ksplit);
  kernel<<<grid, T::kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

// The launch plan from ops/fused_chain.py `launch_plan`.
struct Plan {
  int tile_h, tile_n, ksplit, smem_bytes;
};

// Checks the shape and plan and fills p's geometry; false if the kernel
// does not take them.
bool set_geometry(ConvArgs* p, int batch, int c, int h, int w,
                  const Plan& plan) {
  const int chunks = (c + kChunk - 1) / kChunk;
  if (batch <= 0 || batch > 65535 || c <= 0 || h <= 0 || w <= 0 ||
      c % 8 != 0 || plan.tile_h <= 0 || plan.ksplit <= 0 ||
      chunks % plan.ksplit != 0 || (plan.ksplit > 1) != (p->partial != nullptr)) {
    return false;
  }
  p->batch = batch;
  p->C = c;
  p->H = h;
  p->W = w;
  p->tiles_w = (w + kTileW - 1) / kTileW;
  p->tiles_hw = p->tiles_w * ((h + plan.tile_h - 1) / plan.tile_h);
  p->chunks_per_split = chunks / plan.ksplit;
  return (long long)batch * p->tiles_hw <= 0x7fffffffLL;
}

// One conv pass (and, with a K split, its reduce) on a checked ConvArgs.
cudaError_t run_pass(const ConvArgs& p, const Plan& plan,
                     cudaStream_t stream) {
  cudaError_t err;
  const int th = plan.tile_h, tn = plan.tile_n;
  if (th == 32 && tn == 64) {
    err = launch_conv<32, 64>(p, plan.ksplit, plan.smem_bytes, stream);
  } else if (th == 32 && tn == 32) {
    err = launch_conv<32, 32>(p, plan.ksplit, plan.smem_bytes, stream);
  } else if (th == 16 && tn == 64) {
    err = launch_conv<16, 64>(p, plan.ksplit, plan.smem_bytes, stream);
  } else if (th == 16 && tn == 32) {
    err = launch_conv<16, 32>(p, plan.ksplit, plan.smem_bytes, stream);
  } else if (th == 8 && tn == 64) {
    err = launch_conv<8, 64>(p, plan.ksplit, plan.smem_bytes, stream);
  } else if (th == 8 && tn == 32) {
    err = launch_conv<8, 32>(p, plan.ksplit, plan.smem_bytes, stream);
  } else if (th == 4 && tn == 32) {
    err = launch_conv<4, 32>(p, plan.ksplit, plan.smem_bytes, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || plan.ksplit == 1) return err;
  const size_t total = (size_t)p.batch * p.C * p.H * p.W;
  const size_t blocks = (total + 255) / 256;
  ksplit_reduce_kernel<<<blocks < 65535 ? (int)blocks : 65535, 256, 0,
                         stream>>>(p, plan.ksplit);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t to_nhwc_bf16(const Tin* x, __nv_bfloat16* y, int batch, int c,
                         int hw, cudaStream_t stream) {
  const dim3 grid((hw + 31) / 32, (c + 31) / 32, batch);
  nchw_to_nhwc_bf16_kernel<Tin><<<grid, dim3(32, 8), 0, stream>>>(x, y, c,
                                                                  hw);
  return cudaGetLastError();
}

}  // namespace

// One conv pass on the tensor cores:
//   out = relu(conv3x3(bf16(x), w) * scale + shift [+ residual])
// x, residual, out: (batch, c, h, w) f32; xb: (batch, h, w, c) bf16
// scratch for x's operand; w: one packed (3c, 3c) bf16 matrix; residual
// may be null. The plan (tile_h, tile_n, ksplit, smem_bytes) comes from
// ops/fused_chain.py `launch_plan`; with ksplit > 1, partial is an f32
// workspace of ksplit * batch * c * h * w, else null. c must be a multiple
// of 8 and ksplit must divide ceil(c / 32). Launches the conversion of x,
// the pass and, with a K split, its reduce. Returns the first failing
// launch's cudaError_t, or 0.
extern "C" int romp_conv3x3_bn_act(const float* x, void* xb, const void* w,
                                   const float* scale, const float* shift,
                                   const float* residual, float* out,
                                   float* partial, int batch, int c, int h,
                                   int w_dim, int tile_h, int tile_n,
                                   int ksplit, int smem_bytes,
                                   cudaStream_t stream) {
  const Plan plan{tile_h, tile_n, ksplit, smem_bytes};
  ConvArgs p{};
  p.x = reinterpret_cast<const __nv_bfloat16*>(xb);
  p.w = reinterpret_cast<const __nv_bfloat16*>(w);
  p.scale = scale;
  p.shift = shift;
  p.residual = residual;
  p.out = out;
  p.partial = partial;
  if (!set_geometry(&p, batch, c, h, w_dim, plan)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = to_nhwc_bf16(x, reinterpret_cast<__nv_bfloat16*>(xb),
                                 batch, c, h * w_dim, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)run_pass(p, plan, stream);
}

// A chain of `blocks` BasicBlocks, 2 * blocks passes of the kernel above
// (one host call, so a small batch does not wait on the host):
//   h = relu(conv(y) * scale[n, 0] + shift[n, 0])             (bf16 only)
//   y = relu(conv(h) * scale[n, 1] + shift[n, 1] + y)   (f32 and bf16)
// x: (batch, c, h, w) f32, y_0 = x; y_n ends in out[(n - 1) % 2], two f32
// buffers of x's shape. xb, hb: (batch, h, w, c) bf16 scratch (xb holds
// bf16(y_n) for the next conv1). w: (blocks, 2, 3c, 3c) bf16; scale,
// shift: (blocks, 2, c) f32. Plan and partial as for romp_conv3x3_bn_act.
extern "C" int romp_basic_chain(const float* x, void* xb, void* hb,
                                float* out0, float* out1, float* partial,
                                const void* w, const float* scale,
                                const float* shift, int blocks, int batch,
                                int c, int h, int w_dim, int tile_h,
                                int tile_n, int ksplit, int smem_bytes,
                                cudaStream_t stream) {
  const Plan plan{tile_h, tile_n, ksplit, smem_bytes};
  ConvArgs p{};
  p.partial = partial;
  if (blocks <= 0 || !set_geometry(&p, batch, c, h, w_dim, plan)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* x_b = reinterpret_cast<__nv_bfloat16*>(xb);
  auto* h_b = reinterpret_cast<__nv_bfloat16*>(hb);
  const auto* w_b = reinterpret_cast<const __nv_bfloat16*>(w);
  cudaError_t err = to_nhwc_bf16(x, x_b, batch, c, h * w_dim, stream);
  const float* y = x;
  float* outs[2] = {out0, out1};
  for (int n = 0; n < blocks && err == cudaSuccess; ++n) {
    for (int j = 0; j < 2 && err == cudaSuccess; ++j) {
      const int k = 2 * n + j;
      p.w = w_b + (size_t)k * 9 * c * c;
      p.scale = scale + (size_t)k * c;
      p.shift = shift + (size_t)k * c;
      p.x = j == 0 ? x_b : h_b;
      p.residual = j == 0 ? nullptr : y;
      p.out = j == 0 ? nullptr : outs[n % 2];
      // conv2 overwrites xb with bf16(y_next): conv1 read it already
      p.out_bf16 = j == 0 ? h_b : (n + 1 < blocks ? x_b : nullptr);
      err = run_pass(p, plan, stream);
    }
    y = outs[n % 2];
  }
  return (int)err;
}

// The chain with bf16 input and output (see the header): x and out are
// (batch, c, h, w) bf16; y_1 .. y_{blocks-1} alternate in out0 / out1, two
// f32 buffers of x's shape (out1 unused below three blocks); the last
// block's conv2 writes out only. Scratch, weights and plan as for
// romp_basic_chain.
extern "C" int romp_basic_chain_bf16(const void* x, void* xb, void* hb,
                                     float* out0, float* out1, void* out,
                                     float* partial, const void* w,
                                     const float* scale, const float* shift,
                                     int blocks, int batch, int c, int h,
                                     int w_dim, int tile_h, int tile_n,
                                     int ksplit, int smem_bytes,
                                     cudaStream_t stream) {
  const Plan plan{tile_h, tile_n, ksplit, smem_bytes};
  ConvArgs p{};
  p.partial = partial;
  if (blocks <= 0 || !set_geometry(&p, batch, c, h, w_dim, plan)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* x_in = reinterpret_cast<const __nv_bfloat16*>(x);
  auto* x_b = reinterpret_cast<__nv_bfloat16*>(xb);
  auto* h_b = reinterpret_cast<__nv_bfloat16*>(hb);
  const auto* w_b = reinterpret_cast<const __nv_bfloat16*>(w);
  cudaError_t err = to_nhwc_bf16(x_in, x_b, batch, c, h * w_dim, stream);
  const float* y = nullptr;   // y_n in f32 (n >= 1); y_0 is x_in
  float* outs[2] = {out0, out1};
  for (int n = 0; n < blocks && err == cudaSuccess; ++n) {
    const bool last = n + 1 == blocks;
    for (int j = 0; j < 2 && err == cudaSuccess; ++j) {
      const int k = 2 * n + j;
      p.w = w_b + (size_t)k * 9 * c * c;
      p.scale = scale + (size_t)k * c;
      p.shift = shift + (size_t)k * c;
      p.x = j == 0 ? x_b : h_b;
      p.residual = j == 0 || n == 0 ? nullptr : y;
      p.residual_bf16 = j == 1 && n == 0 ? x_in : nullptr;
      p.out = j == 0 || last ? nullptr : outs[n % 2];
      p.out_nchw_bf16 = j == 1 && last ? reinterpret_cast<__nv_bfloat16*>(out)
                                       : nullptr;
      p.out_bf16 = j == 0 ? h_b : (last ? nullptr : x_b);
      err = run_pass(p, plan, stream);
    }
    y = outs[n % 2];
  }
  return (int)err;
}
