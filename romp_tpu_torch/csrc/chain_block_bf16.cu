// One BasicBlock of the bf16-in / bf16-out chain in one launch
// (chain_block_bf16_kernel), on Hopper's tensor cores (sm_90a).
//
// Replaces, on the bf16-activation path, the passes that
// romp_tpu/ops/pallas_fuse.py::fused_basic_chain (pallas_call :149, bf16
// input :146, bf16 result :174) was first ported to (basic_chain.cu,
// romp_basic_chain_bf16: a NCHW -> NHWC conversion, then two conv passes a
// block). It computes what `basic_chain_plain` computes on a bf16 x: x is
// widened to f32 and, per block,
//   h = relu(conv3x3(bf16(y)) * scale1 + shift1)
//   y = relu(conv3x3(bf16(h)) * scale2 + shift2 + y),
// the last y rounded to bf16 NCHW. Its sums are those of
// conv3x3_bn_act_mma_kernel (mma.sync.m16n8k16 bf16 x bf16 -> f32, each
// output's K in 32-channel chunks, then taps 0-8, then 16-channel steps,
// the same lanes' fragments) and its epilogues the same operations in the
// same order, so the chain stays bit-equal to the f32 chain on x.float(),
// rounded, wherever that chain does not split K (the plan, ops/
// fused_chain.py `bf16_chain_plan`, takes the passes there).
//
// Design:
// - One launch a block; h never leaves the chip. A CTA owns an output tile
//   of TH x TW pixels. Its block input's window, the tile +- 2 pixels of all
//   C channels, arrives channel-major (NCHW order) in a staging buffer.
//   The consumer warps rewrite it pixel-major as bf16 into A (rows of C
//   values, their 16-byte units XOR-swizzled by the pixel), rounding an
//   f32 input once with __float2bfloat16_rn (what the parent's bf16 NHWC
//   copy held), and read the residual (the window's centre, exact) into
//   registers; then the stage is free for the window after next.
// - conv1 runs over h's region, the tile +- 1 pixel, taken as rows of the
//   window's width (the last two columns of each computed and dropped), so
//   that its A rows sit at a uniform stride: both operands come from shared
//   memory through wgmma descriptors, and a warpgroup issues every k16
//   step of its m64 blocks at once and waits once. Its epilogue writes
//   h = bf16(relu(acc * scale1 + shift1)) into shared memory (pixel rows,
//   swizzled as A's), and zero where h's pixel lies outside the image:
//   conv2's SAME padding pads h with zeros, it does not evaluate conv1
//   there. The window outside the image is zero too (conv1's padding).
// - conv2 runs over the tile from h: its A rows (the tile's pixels in h's
//   wider rows) come from ldmatrix into three register buffers two steps
//   ahead, B through descriptors (wgmma m64nNk16 with A in registers), a
//   step's group queued behind the last one's. At C = 64 its one
//   m64 block is split along N between the two warpgroups. Its sums go
//   through an out-stage (f32 channel planes in A's place) so that the
//   epilogue writes 16-byte runs of 4 pixels of a channel row:
//   relu(acc * scale2 + shift2 + residual), f32 NCHW for the inner blocks,
//   as the TPU kernel keeps them f32 in VMEM, bf16 NCHW for the last.
// - wgmma's sums are mma.sync's bit for bit (measured on the H100 for
//   both operand forms and every row offset), so the K order above keeps
//   the chain bit-equal to the f32 chain.
// - No conversion pass: block 0 reads x as bf16 NCHW.
// - Persistent CTAs (one an SM: the wrapper passes the SM count) take the
//   tiles t = blockIdx.x, + gridDim.x, ... A producer warp keeps the next
//   tiles' windows in flight into a ring of `stages` staging buffers,
//   each arrival signalled by an mbarrier: a TMA load of a 4D tensor map
//   over the block input (W, H, C, B), box (the window's columns from the
//   16-byte boundary left of it, rounded up to 16 bytes; TH + 4 rows; C;
//   1), which reads zero outside the tensor: that zero is conv1's padding.
//   (A box whose first column is not 16-byte aligned faults on the card:
//   an illegal instruction.) The map is encoded on the host by
//   cuTensorMapEncodeTiled, which the runtime's
//   cudaGetDriverEntryPoint[ByVersion] returns (no -lcuda). Where TMA's
//   16-byte rule fails (W % 8 != 0, or an unaligned pointer) the entry
//   point refuses the shape and the plan takes the passes: a copy path by
//   the producer's lanes measured 3-4.5x slower than the passes there.
// - The weights of both convs and their scale and shift stay in shared
//   memory for the whole launch, copied once a CTA; the weights as
//   [tap][ci][co] rows of C values swizzled as A's, which from a
//   1024-byte aligned base is wgmma's 64-byte (C = 32) or 128-byte (C =
//   64) swizzle of an MN-major operand.
// - Two consumer warpgroups (8 warps) and a producer warpgroup of which
//   one warp works. Four consumer barriers a tile: after the rewrite,
//   after conv1's epilogue (h written, A free), after conv2's sums reach
//   the out-stage, after the epilogue has read it.
//
// Plans (ops/fused_chain.py `bf16_chain_plan`; tile, shared memory,
// stages, and the MMAs over the tile's own):
//   C = 32: 16 x 16, 215,424 B, 2 stages; conv1 over 18 x 20 = 360 rows in
//           6 m64 blocks (384) for 256 (x 1.5; h's region alone is 324,
//           x 1.27), conv2 4 blocks: the block x 1.25.
//   C = 64: 8 x 8, 230,016 B, 1 stage; conv1 over 10 x 12 = 120 rows in 2
//           blocks (128) for 64 (x 2; h's region 100, x 1.56), conv2 1
//           block: the block x 1.5. The weights (147,456 B) leave no room
//           for a larger tile or a second stage.
//   C = 128 and 256 keep the passes (basic_chain.cu): both convs' weights
//   are 589,824 B and 2.4 MB there. So does any shape where the f32
//   chain's plan splits K (its partial sums add in another order).
//
// Bytes (device memory, per element of a 4-block chain, halo rereads from
// L2 not counted): block 0 reads bf16 x (2) and writes f32 y (4); blocks 1
// and 2 read y (4) and write y (4); block 3 reads y (4) and writes bf16
// (2): 28, against the parent's 62 (its conversion, h's round trip and the
// bf16 NHWC copy of every block output). A bf16 copy beside each inner
// output would make it 40 and was not built: the f32 window is read once
// and rounded on chip, which is the copy's value.
//
// Bound (as the parent's, chip_smoke.py phase 3; H100 SXM, 989 TFLOP/s
// bf16, 3.35 TB/s): 8 convs of 2 * 9 * C^2 * HW FLOP an image, 154.6 GFLOP
// at B = 64, 0.156 ms (operations); the 28 bytes an element are 0.28 ms at
// C = 32, B = 64 and halve with each wider branch. With the recomputed
// and dropped MMAs the operations are 0.195 ms at C = 32 and 0.234 at
// C = 64.
//
// Registers (nvcc -Xptxas -v, sm_90a): 168 a thread, no spills, every
// instantiation (12 warps' share; chip_smoke.py phase 2 prints them). A
// single producer warp (9 warps, no setmaxnreg) measured slower: 0.90 /
// 0.89 ms at C = 32 / 64, B = 64, against 0.86 / 0.72, with ptxas
// allocating 126-168 registers.
//
// Tried on the H100 and not kept (PERF.md): mma.sync
// (m16n8k16, fragments by ldmatrix) for both convs, with 4, 8 or 16
// consumer warps (8 best, and slower than wgmma: 0.98 / 1.16 ms at C = 32
// / 64, B = 64); fragments loaded a step ahead under mma.sync (no
// faster); conv1 with A in registers; the residual loaded from device
// memory at the epilogue or at the tile's start (36 us a block at C = 64
// more than from the stage); a stage held until the epilogue for the
// residual; conv2's taps not unrolled (fewer registers, 30% slower);
// scale and shift read from device memory in the epilogues (0.99 / 1.01
// ms against 0.87 / 0.79 from shared memory); conv2's A in two register
// buffers (0.88 / 0.81 against 0.86 / 0.72 with three; four no faster,
// and a spill); the rewrite's loads one channel value at a time (pairs
// save 1%).
//
// Measurement builds only (utils/chain_plans.py --breakdown --bf16):
// -DROMP_CHAIN_FUSED_SKIP=mask leaves out the window's loads (1: the
// producer signals without loading), the MMAs (2), conv2's epilogue (4),
// conv1's epilogue, h's stage (8), the rewrite of the window into A
// (16), the residual (128), the output's stores (256), conv2's MMAs alone
// (1024);
// The results of a SKIP build are wrong.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef ROMP_CHAIN_FUSED_SKIP
#define ROMP_CHAIN_FUSED_SKIP 0
#endif
constexpr int kSkip = ROMP_CHAIN_FUSED_SKIP;

constexpr int kChunk = 32;          // input channels a K chunk
constexpr int kMaxSmem = 232448;    // shared memory a block can use
constexpr int kMaxStages = 2;
constexpr int kABuf = 3;            // conv2's A register buffers
constexpr int kCW = 8;              // consumer warps: two warpgroups
constexpr int kCThreads = kCW * 32;
// and a producer warpgroup, of which one warp works: 12 warps have 168
// registers a thread, too few for the consumers (they spill), so the
// producers give theirs up (setmaxnreg) and the consumers take 232
constexpr int kThreads = kCThreads + 128;

__host__ __device__ constexpr int align128(int n) {
  return (n + 127) / 128 * 128;
}

// The geometry of one instantiation: C channels, TH x TW output tiles.
template <int C, int TH, int TW>
struct Geo {
  static constexpr int kWinH = TH + 4, kWinW = TW + 4;   // the window
  static constexpr int kHH = TH + 2, kHW = TW + 2;       // h's region
  static constexpr int kWinPix = kWinH * kWinW;
  static constexpr int kHPix = kHH * kHW;
  // m64 blocks (wgmma's M) of each conv: conv1 over h's region (rows past
  // it computed and dropped), conv2 over the tile; conv2's single block at
  // C = 64 (8 x 8) is split along N between the two warpgroups
  static constexpr int kM1 = kHH * kWinW;   // conv1's rows: h's, window-wide
  static constexpr int kB1 = (kM1 + 63) / 64;
  static constexpr int kB2 = TH * TW / 64;
  static constexpr int kMB1 = (kB1 + 1) / 2;        // a warpgroup's blocks
  static constexpr bool kSplitN2 = kB2 == 1;
  static constexpr int kMB2 = kSplitN2 ? 1 : kB2 / 2;
  static constexpr int kN2 = kSplitN2 ? C / 2 : C;  // conv2's wgmma N
  static constexpr int kRow = C * 2;                // bytes a pixel / weight row
  static constexpr int kWBytes = 9 * C * kRow;      // one conv's weights
  // the out-stage: conv2's sums, C planes of the tile in f32, planes
  // padded by 4 (conflict-free stores from the fragments); it takes A's
  // place, which is at least its size
  static constexpr int kOSStride = TH * TW + 4;
  static constexpr int kABytes = kWinPix * kRow > C * kOSStride * 4
                                     ? kWinPix * kRow : C * kOSStride * 4;
  static constexpr int kHBytes = kHPix * kRow;
  // conv2's epilogue units (4 pixels of a channel row) a consumer thread
  static constexpr int kUnits = C * TH * TW / 4 / kCThreads;
  // the staging buffer: C planes of kWinH rows. A TMA box starts at a
  // 16-byte aligned column (the card faults on others), so a staged row
  // starts kLead = 16 / sizeof(T) columns left of the tile (the window's
  // 2 and the alignment's rest) and is kLead + TW + 2 columns rounded up
  // to 16 bytes; sized for the f32 input (the larger)
  static constexpr int kBoxWF = (TW + 2 + 4 + 3) / 4 * 4;    // f32 row
  static constexpr int kBoxWB = (TW + 2 + 8 + 7) / 8 * 8;    // bf16 row
  static constexpr int kStageBytes = align128(C * kWinH * kBoxWF * 4);
  // byte offsets from the 1024-aligned base (the weights' swizzle is
  // wgmma's, on address bits): both convs' weights, A, h, both convs'
  // scale and shift, the mbarriers (full and empty a stage), the stages
  static constexpr int kOffA = 2 * kWBytes;
  static constexpr int kOffH = kOffA + kABytes;
  static constexpr int kOffSS = kOffH + kHBytes;   // scale1, shift1, scale2, shift2
  static constexpr int kOffBars = kOffSS + 4 * C * 4;
  static constexpr int kOffStage = align128(kOffBars + 2 * kMaxStages * 8);
  __host__ __device__ static constexpr int smem(int stages) {
    return kOffStage + stages * kStageBytes + 1024;   // + aligning the base
  }
  static_assert(C == 32 || C == 64, "wgmma N and the swizzles: C 32 or 64");
  static_assert(TH * TW % 64 == 0, "conv2's M in m64 blocks");
  static_assert(kSplitN2 || kB2 % 2 == 0, "conv2's blocks per warpgroup");
  static_assert(TW % 8 == 0, "tiles start at 16-byte aligned bf16 columns");
  static_assert(kWinPix / 2 % 8 == 0, "a quarter-warp's pairs in one q");
  static_assert(C * TH * TW / 4 % kCThreads == 0, "epilogue units");
  static_assert(kBoxWB <= 256 && kWinH <= 256 && C <= 256, "TMA box dims");
};

template <typename Tin>
__host__ __device__ constexpr int box_w(int f32_w, int bf16_w) {
  return sizeof(Tin) == 4 ? f32_w : bf16_w;
}

struct BlockArgs {
  const void* x;              // block input (B, C, H, W): bf16 or f32
  const __nv_bfloat16* w;     // (2, 3C, 3C): conv1's, conv2's packed weights
  const float* scale;         // (2, C)
  const float* shift;         // (2, C)
  float* out;                 // (B, C, H, W) f32, or null
  __nv_bfloat16* out_bf16;    // (B, C, H, W) bf16, or null (the last block)
  int B, H, W, tiles_w, tiles, stages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D (m64 x 32, f32) += A (m64 x k16 bf16, this warp's 16 rows in
// registers, mma.m16n8k16's A fragment) . B (k16 x 32 bf16, MN-major in
// shared memory, described by desc); D's fragment is mma.m16n8k16's C
// fragment of each n8 tile in turn
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
      "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The same with A (m64 x k16, K-major, pixel rows) from shared memory
// too, described by desc_a
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
      "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// the consumer warps only (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCThreads) : "memory");
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two channels' values as a packed bf16 pair: an f32 input rounded to
// nearest even, a bf16 one as it is
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return pack_bf16(lo, hi);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// two neighbouring staged values of one channel (8-byte aligned f32 or
// 4-byte aligned bf16 pairs)
template <typename T>
struct Pair {
  T a, b;
};
__device__ __forceinline__ Pair<float> ld_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return {v.x, v.y};
}
__device__ __forceinline__ Pair<__nv_bfloat16> ld_pair(
    const __nv_bfloat16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return {v.x, v.y};
}

// The swizzle of a row's 16-byte units (weights: row = tap * C + ci; A
// and h: row = pixel): unit q of row r sits at q ^ swz(r). With the rows'
// base 1024-byte aligned this is wgmma's 64-byte (C = 32: rows of 64
// bytes, two to 128) or 128-byte (C = 64) swizzle of an MN-major operand,
// and the 8 rows of an ldmatrix matrix fall in distinct banks.
template <int C>
__host__ __device__ __forceinline__ int swz(int r) {
  return C >= 64 ? (r & 7) : ((r >> 1) & 3);
}

// the byte offset of unit q of row r
template <int C>
__device__ __forceinline__ uint32_t row_unit(int r, int q) {
  return (uint32_t)(r * C * 2 + ((q ^ swz<C>(r)) << 4));
}

// The wgmma descriptor of a k16 x N slice of a conv's weights in shared
// memory (MN-major, rows of C bf16 values, swizzled as above): start
// address, leading offset 1 (one atom across N), stride offset 8 rows,
// the swizzle's layout type (64 bytes: 2, 128 bytes: 1).
template <int C>
__device__ __forceinline__ uint64_t w_desc(uint32_t addr) {
  constexpr uint64_t kSbo = 8 * C * 2 / 16;
  constexpr uint64_t kLayout = C >= 64 ? 1 : 2;
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (kSbo << 32) |
         (kLayout << 62);
}

// The residual's 4 consecutive pixels of one channel from the staged
// window, widened to f32: asm volatile, so that the reads stay ahead of
// the stage's release (the compiler moved plain loads past it, and the
// producer's next window overwrote them)
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  uint32_t lo, hi;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(lo), "=r"(hi)
               : "r"(smem_addr(p))
               : "memory");
  return make_float4(__uint_as_float(lo << 16),
                     __uint_as_float(lo & 0xffff0000u),
                     __uint_as_float(hi << 16),
                     __uint_as_float(hi & 0xffff0000u));
}

// conv1 of a warpgroup: MB m64 blocks of pixel rows of the window (rows
// m = bi * 64 + r, window pixel m + tap's offset: A's rows at a uniform
// stride, so A comes from shared memory through descriptors too) by all C
// output channels. K in 32-channel chunks, then taps 0-8, then 16-channel
// steps (conv3x3_bn_act_mma_kernel's order; wgmma sums each output's k16
// steps bit for bit as mma.sync does, measured on the H100, with either
// operand in shared memory at any row). Every step is issued at once and
// waited for at the end.
template <int C, int MB, int kSrcW>
__device__ __forceinline__ void conv1_wgmma(float (&d)[MB][C / 2],
                                            const int (&blk)[MB],
                                            uint32_t a_base,
                                            uint32_t w_base) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < C / 2; ++e) d[mb][e] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
  for (int ch = 0; ch < C / kChunk; ++ch) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int k0 = ch * kChunk + kk * 16;
        const uint64_t desc_b =
            w_desc<C>(w_base + (uint32_t)(tap * C + k0) * C * 2);
        const int toff = (tap / 3) * kSrcW + tap % 3;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const uint64_t desc_a = w_desc<C>(
              a_base + (uint32_t)((blk[mb] * 64 + toff) * C + k0) * 2);
          if (kSkip & 2) {   // no MMAs
            d[mb][0] += __uint_as_float((uint32_t)(desc_a ^ desc_b));
          } else if (C == 64) {
            wgmma_ss_n64(d[mb], desc_a, desc_b);
          } else {
            wgmma_ss_n32(d[mb], desc_a, desc_b);
          }
        }
      }
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// conv2 of a warpgroup: MB m64 blocks of the tile's pixels by N output
// channels, in conv1's K order. A: this warp's 16 rows of each block from
// h (pixel p0[mb] at tap (0, 0), kSrcW pixels a row: the tile's rows are
// not at a uniform stride there) by ldmatrix, a step ahead of the MMAs
// (two register buffers); B: the weights (w_base: conv2's, plus the
// warpgroup's first output channel) through descriptors. Returns with
// every wgmma complete.
template <int C, int MB, int N, int kSrcW>
__device__ __forceinline__ void conv2_wgmma(float (&d)[MB][N / 2],
                                            const int (&p0)[MB],
                                            uint32_t src, uint32_t w_base,
                                            int lane) {
  constexpr int kSteps = C / kChunk * 18;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) d[mb][e] = 0.f;
  // kABuf register buffers: step s + kABuf - 1 loads while the groups of
  // steps s - 1 and s run, so a step's wgmma never waits on its ldmatrix
  uint32_t af[kABuf][MB][4];
  const int qh = lane >> 4;   // ldmatrix: lanes 16-31 read k 8-15
  auto load = [&](int step, int buf) {
    const int ch = step / 18, tap = (step % 18) / 2;
    const int q = (ch * kChunk + (step % 2) * 16) / 8 + qh;
    const int toff = (tap / 3) * kSrcW + tap % 3;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      ldmatrix_x4(src + row_unit<C>(p0[mb] + toff, q), af[buf][mb]);
    }
  };
#pragma unroll
  for (int step = 0; step < kABuf - 1; ++step) load(step, step);
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int cur = step % kABuf;
    const int ch = step / 18, tap = (step % 18) / 2;
    const int k0 = ch * kChunk + (step % 2) * 16;
    const uint64_t desc = w_desc<C>(w_base + (uint32_t)(tap * C + k0) * C * 2);
    if (kSkip & (2 | 1024)) {   // no MMAs: keep the operands' loads live
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        d[mb][0] += __uint_as_float(af[cur][mb][0] ^ (uint32_t)desc);
    } else {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        if (N == 64) {
          wgmma_n64(d[mb], af[cur][mb], desc);
        } else {
          wgmma_n32(d[mb], af[cur][mb], desc);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the groups that read the buffer loaded next are done
      asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kABuf - 2)
                   : "memory");
    }
    if (step + kABuf - 1 < kSteps) {
      load(step + kABuf - 1, (step + kABuf - 1) % kABuf);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int C, int TH, int TW, typename Tin>
__global__ void __launch_bounds__(kThreads, 1)
chain_block_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const BlockArgs a) {
  using G = Geo<C, TH, TW>;
  constexpr int kBoxW = box_w<Tin>(G::kBoxWF, G::kBoxWB);
  constexpr int kPlane = G::kWinH * kBoxW;          // staged values a channel
  constexpr int kLead = 16 / (int)sizeof(Tin);      // staged columns left of the tile
  constexpr int kStageLoad = C * kPlane * (int)sizeof(Tin);
  // aligned by pointer arithmetic: the compiler then keeps the pointers in
  // the shared space
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int S = a.stages;
  const uint32_t bars = smem_addr(smem + G::kOffBars);   // full[s], empty[s]
  const uint32_t w_s = smem_addr(smem);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + G::kOffA);
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem + G::kOffH);
  float* Os = reinterpret_cast<float*>(smem + G::kOffA);   // the out-stage
  unsigned char* stages = smem + G::kOffStage;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int total = a.B * a.tiles;
  const size_t plane = (size_t)a.H * a.W;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                      // full
      mbar_init(bars + 8 * (S + s), kCW);              // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kCW) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != kCW) return;
    // ---- the producer warp: each tile's window into the next stage
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int b = t / a.tiles, r = t - b * a.tiles;
      const int ty0 = r / a.tiles_w * TH, tx0 = (r % a.tiles_w) * TW;
      const uint32_t full = bars + 8 * s, empty = bars + 8 * (S + s);
      unsigned char* dst = stages + s * G::kStageBytes;
      mbar_wait(empty, ph ^ 1);
      if (lane == 0) {
        if (kSkip & 1) {   // no loads: the consumers alone
          mbar_arrive(full);
        } else {
          mbar_expect_tx(full, kStageLoad);
          tma_load_4d(smem_addr(dst), &tm_x, full, tx0 - kLead, ty0 - 2, 0,
                      b);
        }
      }
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // ---- the consumer warps: two warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // both convs' weights, [conv][tap][ci][co] rows, units swizzled
  for (int i = tid; i < 2 * 9 * C * (C / 8); i += kCThreads) {
    const int q = i % (C / 8);
    const int row = i / (C / 8);            // conv * 9C + tap * C + ci
    const int j = row / (9 * C), rr = row - j * 9 * C;
    const int tap = rr / C, ci = rr - tap * C;
    const uint4 v = *reinterpret_cast<const uint4*>(
        a.w + (size_t)j * 9 * C * C + (size_t)((tap / 3) * C + ci) * 3 * C +
        (tap % 3) * C + q * 8);
    *reinterpret_cast<uint4*>(smem + j * G::kWBytes + row_unit<C>(rr, q)) = v;
  }
  // and their scale and shift (device memory far from the epilogues)
  float* ss = reinterpret_cast<float*>(smem + G::kOffSS);
  for (int i = tid; i < 2 * C; i += kCThreads) {
    ss[(i / C) * 2 * C + i % C] = __ldg(a.scale + i);
    ss[(i / C) * 2 * C + C + i % C] = __ldg(a.shift + i);
  }
  // wgmma reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int wg = warp >> 2, wi = warp & 3;   // warpgroup, its warp
  const int g = lane >> 2, tq = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix's row
  const uint32_t a_s = smem_addr(As), h_s = smem_addr(Hs);
  // conv2's first output channel of this warpgroup (N split at C = 64)
  const int n2 = G::kSplitN2 ? wg * G::kN2 : 0;

  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = t / a.tiles, r = t - b * a.tiles;
    const int ty0 = r / a.tiles_w * TH, tx0 = (r % a.tiles_w) * TW;
    const Tin* st = reinterpret_cast<const Tin*>(stages + s * G::kStageBytes);
    const uint32_t empty = bars + 8 * (S + s);

    // -- the window, channel-major in the stage -> A, pixel-major bf16
    mbar_wait(bars + 8 * s, ph);
    if (!(kSkip & 16)) {
      // a unit: two neighbouring pixels (one row: kWinW is even) by 8
      // channels, read as pairs; the lanes of a quarter-warp store their
      // even or their odd pixel first, so that the 8 rows of each store
      // fall in distinct banks
      constexpr int kPairs = G::kWinPix / 2;
      const int first = (lane >> 2) & 1;
      for (int u = tid; u < kPairs * (C / 8); u += kCThreads) {
        const int q = u / kPairs, p = 2 * (u - q * kPairs);
        const int wy = p / G::kWinW, wx = p - wy * G::kWinW;
        const Tin* src = st + q * 8 * kPlane + wy * kBoxW + wx + kLead - 2;
        uint32_t lo[4], hi[4];   // pixel p's and p + 1's channel pairs
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Pair<Tin> c0 = ld_pair(src + 2 * j * kPlane);
          const Pair<Tin> c1 = ld_pair(src + (2 * j + 1) * kPlane);
          lo[j] = pack2(c0.a, c1.a);
          hi[j] = pack2(c0.b, c1.b);
        }
        unsigned char* a8 = reinterpret_cast<unsigned char*>(As);
        const uint4 v0 = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        const uint4 v1 = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(a8 + row_unit<C>(p + first, q)) =
            first ? v1 : v0;
        *reinterpret_cast<uint4*>(a8 + row_unit<C>(p + 1 - first, q)) =
            first ? v0 : v1;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // -- the residual (the window's centre, exact): the units of conv2's
    // epilogue, a thread's 4 consecutive pixels of one channel's tile row,
    // u = tid + k * threads, into registers; then the stage is free
    const size_t img = (size_t)b * C * plane;
    float4 res[G::kUnits];
#pragma unroll
    for (int k = 0; k < G::kUnits; ++k) {
      const int u = tid + k * kCThreads;
      const int n = u / (TH * TW / 4), r4 = u % (TH * TW / 4);
      const Tin* rs = st + n * kPlane + (r4 / (TW / 4) + 2) * kBoxW +
                      (r4 % (TW / 4)) * 4 + kLead;
      res[k] = (kSkip & 128) ? make_float4(0.f, 0.f, 0.f, 0.f) : lds4(rs);
    }
    // the reads are done before the producer's next TMA write here
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
    consumer_sync();

    // -- conv1 over h's region, as rows of the window's width (the last
    // two columns of each and the rows past h's region computed and
    // dropped): warpgroup wg takes blocks wg, wg + 2, ...
    {
      float d[G::kMB1][C / 2];
      int blk[G::kMB1];
#pragma unroll
      for (int mb = 0; mb < G::kMB1; ++mb) blk[mb] = wg + 2 * mb;
      conv1_wgmma<C, G::kMB1, G::kWinW>(d, blk, a_s, w_s);
      // -- conv1's epilogue: h = bf16(relu(acc * scale1 + shift1)), zero
      // outside the image, into h's pixel-major rows
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int n = j * 8 + 2 * tq;
        const float sc0 = ss[n], sc1 = ss[n + 1];
        const float sh0 = ss[C + n], sh1 = ss[C + n + 1];
#pragma unroll
        for (int mb = 0; mb < G::kMB1; ++mb) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = (blk[mb] * 4 + wi) * 16 + g + half * 8;
            const int hy = m / G::kWinW, hx = m % G::kWinW;
            if (hy >= G::kHH || hx >= G::kHW) continue;
            const int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx;
            float v0 = d[mb][4 * j + 2 * half], v1 = d[mb][4 * j + 2 * half + 1];
            v0 = v0 * sc0 + sh0;
            v1 = v1 * sc1 + sh1;
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
            const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
            if (kSkip & 8) {   // no h stage: keep the sums live
              if (v0 + v1 == 1.5e-38f) As[0] = __float2bfloat16_rn(v0);
              continue;
            }
            *reinterpret_cast<uint32_t*>(
                reinterpret_cast<unsigned char*>(Hs) +
                row_unit<C>(hy * G::kHW + hx, j) + 4 * tq) =
                in ? pack_bf16(v0, v1) : 0u;
          }
        }
      }
    }
    consumer_sync();

    // -- conv2 over the tile, from h; its sums go to the out-stage, channel
    // planes of the tile in A's place (free since the last barrier)
    {
      float d[G::kMB2][G::kN2 / 2];
      int p0[G::kMB2];
#pragma unroll
      for (int mb = 0; mb < G::kMB2; ++mb) {
        const int blk = G::kSplitN2 ? 0 : wg + 2 * mb;
        const int m = (blk * 4 + wi) * 16 + lrow;
        p0[mb] = (m / TW) * G::kHW + m % TW;
      }
      conv2_wgmma<C, G::kMB2, G::kN2, G::kHW>(
          d, p0, h_s, w_s + G::kWBytes + n2 * 2, lane);
      if (kSkip & 4) {   // keep the MMAs: ptxas drops those whose sums are dead
        float sum = 0.f;
#pragma unroll
        for (int mb = 0; mb < G::kMB2; ++mb)
#pragma unroll
          for (int e = 0; e < G::kN2 / 2; ++e) sum += d[mb][e];
        if (sum == 1.5e-38f && a.out != nullptr) a.out[0] = sum;
        consumer_sync();
        continue;
      }
#pragma unroll
      for (int mb = 0; mb < G::kMB2; ++mb) {
        const int blk = G::kSplitN2 ? 0 : wg + 2 * mb;
#pragma unroll
        for (int j = 0; j < G::kN2 / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = (blk * 4 + wi) * 16 + g + half * 8;
            float* o = Os + (n2 + j * 8 + 2 * tq) * G::kOSStride + m;
            o[0] = d[mb][4 * j + 2 * half];
            o[G::kOSStride] = d[mb][4 * j + 2 * half + 1];
          }
      }
    }
    consumer_sync();

    // -- conv2's epilogue, 4 pixels of a channel row a thread:
    // relu(acc * scale2 + shift2 + residual), the operations of
    // conv3x3_bn_act_mma_kernel's epilogue in its order, stored as f32 or
    // (the last block) bf16 NCHW
#pragma unroll
    for (int k = 0; k < G::kUnits; ++k) {
      const int u = tid + k * kCThreads;
      const int n = u / (TH * TW / 4), r4 = u % (TH * TW / 4);
      const int oy = r4 / (TW / 4), ox = (r4 % (TW / 4)) * 4;
      const int gy = ty0 + oy, gx = tx0 + ox;
      if (gy >= a.H || gx >= a.W) continue;
      const float4 acc4 = *reinterpret_cast<const float4*>(
          Os + n * G::kOSStride + oy * TW + ox);
      const float sc = ss[2 * C + n], sh = ss[3 * C + n];
      const size_t o = img + (size_t)n * plane + (size_t)gy * a.W + gx;
      float v[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
      const float rr[4] = {res[k].x, res[k].y, res[k].z, res[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = v[e] * sc + sh;
        v[e] += rr[e];
        v[e] = fmaxf(v[e], 0.f);
      }
      if (kSkip & 256) {   // no stores: keep the values live
        if (v[0] + v[1] + v[2] + v[3] == 1.5e-38f) a.out[0] = v[0];
      } else if (a.out != nullptr) {
        // W % 8 == 0 and 16-byte aligned bases: 4 pixels in the image
        *reinterpret_cast<float4*>(a.out + o) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        *reinterpret_cast<uint2*>(a.out_bf16 + o) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
    }
    // every thread is done with the out-stage before the next rewrite
    consumer_sync();
  }
}

// The kernel's plan for a shape (see ops/fused_chain.py `bf16_chain_plan`):
// ctas persistent CTAs (at most one an SM and one a tile), stages staging
// buffers (as many as fit, up to kMaxStages), smem bytes.
struct FusedPlan {
  int tile_h, tile_w, warps, stages, smem, ctas;
};

// cuTensorMapEncodeTiled from libcuda, through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The block input as a 4D map (W, H, C, B) in boxes of the window (row
// width box_w, th + 4 rows, all c channels, one image); zero outside.
int encode_input(CUtensorMap* map, const void* x, bool f32, int batch,
                 int c, int h, int w, int box_w, int box_h) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dim[4] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)c,
                             (cuuint64_t)batch};
  const cuuint64_t stride[3] = {(cuuint64_t)w * es, (cuuint64_t)h * w * es,
                                (cuuint64_t)c * h * w * es};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, (cuuint32_t)box_h,
                             (cuuint32_t)c, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(x), dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One block's launch. in_f32: the block input is f32 (else bf16 x).
template <int C, int TH, int TW>
cudaError_t launch_block(const BlockArgs& a, bool in_f32, int ctas,
                         int smem, cudaStream_t stream) {
  using G = Geo<C, TH, TW>;
  CUtensorMap map{};
  const int err = encode_input(&map, a.x, in_f32, a.B, C, a.H, a.W,
                               in_f32 ? G::kBoxWF : G::kBoxWB, G::kWinH);
  if (err != 0) return (cudaError_t)err;
  // once per instantiation and process, at the largest plan's size (the
  // port runs on one device)
  constexpr int kSmem = G::smem(kMaxStages) <= kMaxSmem ? G::smem(kMaxStages)
                                                        : G::smem(1);
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(
          chain_block_bf16_kernel<C, TH, TW, __nv_bfloat16>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem),
      cudaFuncSetAttribute(chain_block_bf16_kernel<C, TH, TW, float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem)};
  if (attr[in_f32] != cudaSuccess) return attr[in_f32];
  if (in_f32) {
    chain_block_bf16_kernel<C, TH, TW, float>
        <<<ctas, kThreads, smem, stream>>>(map, a);
  } else {
    chain_block_bf16_kernel<C, TH, TW, __nv_bfloat16>
        <<<ctas, kThreads, smem, stream>>>(map, a);
  }
  return cudaGetLastError();
}

template <int C, int TH, int TW>
bool plan_of(int batch, int h, int w, int sms, FusedPlan* p) {
  using G = Geo<C, TH, TW>;
  const long long tiles =
      (long long)batch * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  if (tiles >= (1ll << 31)) return false;
  p->tile_h = TH;
  p->tile_w = TW;
  p->warps = kCW;
  p->ctas = (int)(tiles < sms ? tiles : sms);
  for (int s = kMaxStages; s >= 1; --s) {
    if (G::smem(s) <= kMaxSmem) {
      p->stages = s;
      p->smem = G::smem(s);
      return true;
    }
  }
  return false;
}

// The instantiations: (C, tile_h, tile_w, consumer warps), each with its
// plan and its launch.
struct Inst {
  int c, tile_h, tile_w, warps;
  bool (*plan)(int batch, int h, int w, int sms, FusedPlan* p);
  cudaError_t (*launch)(const BlockArgs& a, bool in_f32, int ctas, int smem,
                        cudaStream_t stream);
};

constexpr Inst kInsts[] = {
    {32, 16, 16, kCW, plan_of<32, 16, 16>, launch_block<32, 16, 16>},
    {64, 8, 8, kCW, plan_of<64, 8, 8>, launch_block<64, 8, 8>},
};

const Inst* find_inst(int c, int tile_h, int tile_w, int warps) {
  for (const Inst& i : kInsts) {
    if (i.c == c && i.tile_h == tile_h && i.tile_w == tile_w &&
        i.warps == warps) {
      return &i;
    }
  }
  return nullptr;
}

}  // namespace

// The plan of the instantiation (c, tile_h, tile_w, warps) for a batch of
// h x w images on `sms` SMs: out[0..5] = tile_h, tile_w, warps, stages,
// smem bytes, ctas. Returns cudaErrorInvalidValue where there is none.
extern "C" int romp_chain_bf16_fused_plan(int batch, int c, int h, int w,
                                          int tile_h, int tile_w, int warps,
                                          int sms, long long* out) {
  FusedPlan p{};
  const Inst* inst = find_inst(c, tile_h, tile_w, warps);
  if (batch <= 0 || h <= 0 || w <= 0 || sms <= 0 || inst == nullptr ||
      !inst->plan(batch, h, w, sms, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long v[6] = {p.tile_h, p.tile_w, p.warps, p.stages, p.smem,
                          p.ctas};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// The bf16 chain, one launch a block (see the header): x and out (batch,
// c, h, w) bf16; y_1 .. y_{blocks-1} alternate in y0 / y1, f32 buffers of
// x's shape (y1 unused below three blocks, y0 below two); w (blocks, 2,
// 3c, 3c) bf16; scale, shift (blocks, 2, c) f32; all contiguous. The plan
// (tile_h, tile_w, warps, stages, smem, ctas) is the one
// romp_chain_bf16_fused_plan gives. Returns the first failing launch's
// cudaError_t (cudaErrorInvalidValue for shapes or plans the kernel does
// not take: W % 8 != 0 or a pointer not 16-byte aligned among them, where
// TMA cannot read the block input; cudaErrorNotSupported where libcuda has
// no cuTensorMapEncodeTiled), or 0.
extern "C" int romp_chain_bf16_fused(const void* x, float* y0, float* y1,
                                     void* out, const void* w,
                                     const float* scale, const float* shift,
                                     int blocks, int batch, int c, int h,
                                     int w_dim, int tile_h, int tile_w,
                                     int warps, int stages, int smem,
                                     int ctas, int sms, cudaStream_t stream) {
  FusedPlan p{};
  const Inst* inst = find_inst(c, tile_h, tile_w, warps);
  // TMA: 16-byte aligned bases and row strides (W % 8: bf16 x's rows); the
  // epilogue's 16-byte stores want the same of the outputs
  const auto aligned = [](const void* ptr) {
    return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (blocks <= 0 || batch <= 0 || h <= 0 || w_dim <= 0 || sms <= 0 ||
      inst == nullptr || (long long)batch * c * h * w_dim >= (1ll << 31) ||
      (blocks >= 2 && y0 == nullptr) || (blocks >= 3 && y1 == nullptr) ||
      w_dim % 8 != 0 || !aligned(x) || !aligned(y0) || !aligned(y1) ||
      !aligned(out) || !inst->plan(batch, h, w_dim, sms, &p) ||
      p.stages != stages || p.smem != smem || p.ctas != ctas) {
    return (int)cudaErrorInvalidValue;
  }
  BlockArgs a{};
  a.B = batch;
  a.H = h;
  a.W = w_dim;
  a.tiles_w = (w_dim + tile_w - 1) / tile_w;
  a.tiles = a.tiles_w * ((h + tile_h - 1) / tile_h);
  a.stages = stages;
  float* ys[2] = {y0, y1};
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  cudaError_t err = cudaSuccess;
  for (int n = 0; n < blocks && err == cudaSuccess; ++n) {
    const bool last = n + 1 == blocks;
    a.x = n == 0 ? x : static_cast<const void*>(ys[(n - 1) % 2]);
    a.w = wb + (size_t)n * 2 * 9 * c * c;
    a.scale = scale + (size_t)n * 2 * c;
    a.shift = shift + (size_t)n * 2 * c;
    a.out = last ? nullptr : ys[n % 2];
    a.out_bf16 = last ? static_cast<__nv_bfloat16*>(out) : nullptr;
    err = inst->launch(a, n > 0, ctas, smem, stream);
  }
  return (int)err;
}
