// Deformable convolution v1, forward, f32 result, on Hopper's tensor cores
// (sm_90a).
//
// Replaces romp_tpu/ops/pallas_deform.py::deform_conv2d_pallas
// (_warp_kernel): 3x3 taps, stride 1, dilation 1, `deform_groups` groups
// each steering C/G input channels, mmcv offset order
// (channel (g*9 + k)*2 + {0: dy, 1: dx}, tap k = ky*3 + kx), bilinear
// sampling with zero outside the image (each corner checked on its own),
// no mask, no bias:
//   out[b, co, p] = sum_{g,k,c} W[co, g*Cg+c, k] * bilinear(x[b, g*Cg+c],
//                                                   p + tap_k + offset_gk(p))
// The TPU kernel's bilinear one-hot matmuls are a TPU device and are not
// carried over: the 4 neighbours are gathered directly.
//
// What bounds it, at TRACE's shape (B = 8, C = Cout = 32, 128 x 128, G = 8):
// x 16.8 MB + offsets 75.5 MB read once and 16.8 MB written: 0.0326 ms at
// 3.35 TB/s. The (pixels x 288) . (288 x 32) contraction is 2.4 GFLOP,
// 0.036 ms on the CUDA cores at 67 TFLOP/s; in split TF32 on the tensor
// cores (three products at 495 TFLOP/s) it is 0.015 ms, plus 0.005 ms of
// f32 bilinear blends, so bytes bind. In practice the gathers bind (see
// PERF.md): 9.4M (pixel, group, tap) samples, each 4 scattered 16-byte
// corner loads, plus their address and weight arithmetic.
//
// Design:
// - A prologue kernel writes x as (B, G, H*W, Cg): each group's channels
//   interleaved per pixel, so that a corner's Cg = 4 channels are one
//   16-byte load (2 x 16.8 MB moved; most of the write stays in L2). It
//   also writes the weights as split TF32 B fragments (hi, lo), in the
//   order the MMAs read them.
// - A CTA takes a 16 x 8 pixel tile of one frame (the taps' corners then
//   fall in a small window of each group's plane, which L1 keeps) and 32
//   output channels (all of them at TRACE's shape). K = 9 taps x C runs in
//   chunks of one tap and 32 channels (8 groups x Cg 4 at TRACE's shape):
//   4 k steps of 8.
// - cp.async brings each chunk's offset planes (plane-contiguous, 70% of
//   the bytes) and weight fragments into shared memory two chunks ahead.
// - Each chunk has two stages, run one chunk apart on double-buffered
//   samples S, so that chunk k+1's gathers overlap chunk k's MMAs:
//   (a) sample: each thread reads its pixel's (dy, dx) for a group, gathers
//       the 4 corners as float4s, blends them and writes S[pixel, channel]
//       (f32, rows XOR-swizzled: conflict-free stores and ldmatrix);
//   (b) contract: S . W[tap] on mma.sync.m16n8k8 TF32 with the three
//       products lo.hi + hi.lo + hi.hi into f32 accumulators (1e-7 of
//       max|ref|; one TF32 product misses the 1e-4 bar). Each of the 8
//       warps owns 16 pixels x 32 output channels; ldmatrix loads its A
//       fragment, which is split into hi = cvt.rna.tf32(v) and lo =
//       tf32(v - hi) in registers. (S stored already split measured 11%
//       slower on the H100: its 64 KB let 2 CTAs share an SM, where 32 KB
//       let 3.)
// - Any C divisible by G runs: Cg % 4 == 0 gathers float4s, other Cg
//   gather scalars; C past a multiple of 32 and Cout past 32 take more
//   chunks and CTAs, zero-padded.
// - The output is NCHW f32, stored from the accumulators.
//
// bf16 variant (romp_deform_conv2d_bf16; TRACE's bf16-activation path, which
// passes bf16 x and weight with f32 offsets, romp_tpu/models/trace.py:
// 198-201). It reproduces the rounding points of the JAX package's
// deform_conv2d on bf16 operands (romp_tpu/ops/deform_conv.py:43-116): the
// fractions fy, fx rounded to bf16 and 1 - f rounded again; the blend of
// the two rows at each corner column rounded to bf16; the blend of the two
// columns rounded to bf16 (the sample); the weight product accumulated in
// f32. Each blend is two exact products (bf16 x bf16) and one f32 add, so
// its one rounding to bf16 is JAX's. The samples go to shared memory as
// bf16 (rows of 40 values: conflict-free ldmatrix) and the contraction runs
// on mma.sync.m16n8k16 bf16 with f32 accumulation, two k steps a chunk,
// the weights prepared by the prologue as bf16 B fragments. The chunk
// schedule (offsets and weights by cp.async, samples double-buffered one
// chunk ahead of the MMAs) is the f32 kernel's. Output f32. A simple
// kernel first: it shares the f32 kernel's gathers, which bind it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 16;         // pixel tile columns
constexpr int kTH = 8;          // pixel tile rows
constexpr int kPix = kTW * kTH;   // output pixels per CTA
constexpr int kThreads = 256;   // 8 warps, 16 pixels each in the MMAs
constexpr int kCols = 32;       // K columns (channels of one tap) a chunk
constexpr int kN = 32;          // output channels per CTA
constexpr int kWFrag = 4 * 4 * 32;   // float4 B fragments a chunk
constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;
// Measurement builds only (utils/kernel_breakdown.py): -DROMP_DEFORM_SKIP=
// mask leaves out the gathers (1: the corners' weights stand in for the
// samples) or the MMAs (2), so that the time of what is left can be read.
// The results of such a build are wrong.
#ifndef ROMP_DEFORM_SKIP
#define ROMP_DEFORM_SKIP 0
#endif
constexpr int kSkip = ROMP_DEFORM_SKIP;

// weight fragments (3 chunks), S (2 chunks), the offset planes of ngc
// groups (2 chunks)
size_t smem_bytes(int ngc) {
  return (size_t)3 * kWFrag * 16 +
         (size_t)(2 * kPix * kCols + 2 * 2 * ngc * kPix) * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kBytes global -> shared; zero fill when !valid (src is then not read)
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? kBytes : 0;
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

// the split of the weights (prologue): hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ float hi_of(float x) {
  return __uint_as_float(tf32(x));
}

__device__ __forceinline__ float lo_of(float x, float hi) {
  return __uint_as_float(tf32(x - hi));
}

// four 8 x 4 tf32 matrices (8 x 8 b16 to ldmatrix), rows from lanes 8j..8j+7
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The prologue: threads below x_total write x (B, C, HW) as (B, G, HW, Cg),
// C = G * Cg; the others write the split B fragments of the weights, one
// float4 (b0 hi, b1 hi, b0 lo, b1 lo) per (output-channel tile z, chunk c =
// tap * ncb + channel block, k step, n8 tile, lane), b0 = W[co][ci][tap]
// with co = z*32 + nt*8 + lane/4, ci = cb*32 + ks*8 + lane%4, b1 at ci + 4;
// zero past C and Cout.
__global__ void __launch_bounds__(256)
deform_prep_kernel(const float* __restrict__ x, float* __restrict__ xg,
                   const float* __restrict__ w, float4* __restrict__ wfrag,
                   int HW, int Cg, int x_total, int C, int cout, int ncb,
                   int w_total) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < x_total) {
    const int bg = i / HW;      // b * G + g
    const int p = i - bg * HW;
    const float* src = x + (size_t)bg * Cg * HW + p;
    float* dst = xg + (size_t)i * Cg;
    if (Cg % 4 == 0) {
      for (int c = 0; c < Cg; c += 4) {
        reinterpret_cast<float4*>(dst)[c / 4] = make_float4(
            __ldg(src + (size_t)c * HW), __ldg(src + (size_t)(c + 1) * HW),
            __ldg(src + (size_t)(c + 2) * HW),
            __ldg(src + (size_t)(c + 3) * HW));
      }
    } else {
      for (int c = 0; c < Cg; ++c) dst[c] = __ldg(src + (size_t)c * HW);
    }
    return;
  }
  i -= x_total;
  if (i >= w_total) return;
  const int ln = i & 31, nt = (i >> 5) & 3, ks = (i >> 7) & 3;
  const int chunk = (i >> 9) % (kTaps * ncb);
  const int z = (i >> 9) / (kTaps * ncb);
  const int k = chunk / ncb, cb = chunk - k * ncb;
  const int co = z * kN + nt * 8 + (ln >> 2);
  const int ci = cb * kCols + ks * 8 + (ln & 3);
  const float w0 = co < cout && ci < C
      ? __ldg(w + ((size_t)co * C + ci) * kTaps + k) : 0.f;
  const float w1 = co < cout && ci + 4 < C
      ? __ldg(w + ((size_t)co * C + ci + 4) * kTaps + k) : 0.f;
  const float h0 = hi_of(w0), h1 = hi_of(w1);
  wfrag[i] = make_float4(h0, h1, lo_of(w0, h0), lo_of(w1, h1));
}

struct Args {
  const float* xg;      // (B, G, HW, Cg)
  const float* off;     // (B, G * 18, HW)
  const float4* wfrag;  // split B fragments, see deform_prep_kernel
  float* out;           // (B, Cout, HW)
  int C, H, W, G, Cg, cout, pad, ngc;
};

// The corners of one sample: clamped indices and weights (zero where a
// corner is outside the image).
struct Corners {
  int i00, i01, i10, i11;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Corners corners(float ys, float xs, int H, int W) {
  // clamping far-outside coordinates keeps the int conversion defined and
  // changes nothing: every corner stays outside either way
  ys = fminf(fmaxf(ys, -2.f), (float)H + 1.f);
  xs = fminf(fmaxf(xs, -2.f), (float)W + 1.f);
  const float y0f = floorf(ys), x0f = floorf(xs);
  const float ly = ys - y0f, lx = xs - x0f;
  const float hy = 1.f - ly, hx = 1.f - lx;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y0 + 1, 0), H - 1);
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x0 + 1, 0), W - 1);
  Corners r;
  r.w00 = (vy0 && vx0) ? hy * hx : 0.f;
  r.w01 = (vy0 && vx1) ? hy * lx : 0.f;
  r.w10 = (vy1 && vx0) ? ly * hx : 0.f;
  r.w11 = (vy1 && vx1) ? ly * lx : 0.f;
  r.i00 = yc0 * W + xc0;
  r.i01 = yc0 * W + xc1;
  r.i10 = yc1 * W + xc0;
  r.i11 = yc1 * W + xc1;
  return r;
}

// S element (pixel row, column) sits at row * kCols + (col ^ swz(row)):
// the ldmatrix row reads (8 rows, one column quad) and the samples'
// float4 stores (8 consecutive rows, one column quad) are conflict-free.
__device__ __forceinline__ int swz(int row) { return (row & 7) << 2; }

// kCg: the group width when it is 4 (TRACE), else 0 (read at run time);
// Cg % 4 == 0 gathers float4s, other Cg scalars. kVec: floats per
// cp.async of the offset planes (4 where W % 4 == 0, else 1).
template <int kCg, int kVec>
__global__ void __launch_bounds__(kThreads, 3)   // 3 CTAs an SM
deform_conv_tf32_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float4* wf = smem4;                                  // [3][kWFrag]
  float* samp = reinterpret_cast<float*>(wf + 3 * kWFrag);   // [2][kPix][kCols]
  float* obuf = samp + 2 * kPix * kCols;               // [2][2 * ngc][kPix]

  const int Cg = kCg ? kCg : a.Cg;
  const bool quad = Cg % 4 == 0;
  const int HW = a.H * a.W;
  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int ty0 = blockIdx.x / tiles_w * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * kN;
  const int ncb = (a.C + kCols - 1) / kCols;
  const int nc = kTaps * ncb;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const float* offb = a.off + (size_t)b * a.G * 2 * kTaps * HW;
  const float* xb = a.xg + (size_t)b * a.G * HW * Cg;
  const float4* wsrc = a.wfrag + (size_t)blockIdx.z * nc * kWFrag;

  // chunk c's offset planes (dy, dx of its groups) -> obuf[c & 1] and its
  // weight fragments -> wf[c % 3]
  auto load = [&](int c) {
    const int k = c / ncb, cb = c - k * ncb;
    const int g_first = cb * kCols / Cg;
    const int g_last = (min(a.C, cb * kCols + kCols) - 1) / Cg;
    float* dst = obuf + (c & 1) * 2 * a.ngc * kPix;
    const int per_plane = kPix / kVec;
    const int n = (g_last - g_first + 1) * 2 * per_plane;
    for (int i = tid; i < n; i += kThreads) {
      const int plane = i / per_plane;
      const int e = (i - plane * per_plane) * kVec;
      const int ch = ((g_first + plane / 2) * kTaps + k) * 2 + (plane & 1);
      const int y = ty0 + e / kTW, x = tx0 + e % kTW;
      const bool ok = y < a.H && x < a.W;   // W % kVec == 0: all in or out
      cp_async<4 * kVec>(smem_addr(dst + plane * kPix + e),
                         ok ? offb + (size_t)ch * HW + y * a.W + x : a.off,
                         ok);
    }
    for (int i = tid; i < kWFrag; i += kThreads) {
      cp_async<16>(smem_addr(wf + (c % 3) * kWFrag + i),
                   wsrc + (size_t)c * kWFrag + i, true);
    }
  };

  // stage (a): chunk c's samples -> S[c & 1]
  auto sample = [&](int c) {
    const int k = c / ncb, cb = c - k * ncb;
    const int ky = k / 3, kx = k - ky * 3;
    const int g_first = cb * kCols / Cg;
    const float* ob = obuf + (c & 1) * 2 * a.ngc * kPix;
    float* sc = samp + (c & 1) * kPix * kCols;
    const int px = tid % kPix;
    const float yb = (float)(ty0 + px / kTW + ky - a.pad);
    const float xb0 = (float)(tx0 + px % kTW + kx - a.pad);
    if (quad) {
#pragma unroll
      for (int j = 0; j < kCols / 4 / (kThreads / kPix); ++j) {
        const int q = tid / kPix + j * (kThreads / kPix);
        const int ci = cb * kCols + 4 * q;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ci < a.C) {
          const int g = ci / Cg;
          const float* og = ob + (g - g_first) * 2 * kPix + px;
          const Corners r = corners(yb + og[0], xb0 + og[kPix], a.H, a.W);
          const float4* xq = reinterpret_cast<const float4*>(
              xb + (size_t)g * HW * Cg + (ci - g * Cg));
          const int s = Cg / 4;
          if (kSkip & 1) {
            v = make_float4(r.w00, r.w01, r.w10, r.w11);
          } else {
            const float4 c00 = __ldg(xq + (size_t)r.i00 * s);
            const float4 c01 = __ldg(xq + (size_t)r.i01 * s);
            const float4 c10 = __ldg(xq + (size_t)r.i10 * s);
            const float4 c11 = __ldg(xq + (size_t)r.i11 * s);
            v.x = r.w00 * c00.x + r.w01 * c01.x + r.w10 * c10.x +
                  r.w11 * c11.x;
            v.y = r.w00 * c00.y + r.w01 * c01.y + r.w10 * c10.y +
                  r.w11 * c11.y;
            v.z = r.w00 * c00.z + r.w01 * c01.z + r.w10 * c10.z +
                  r.w11 * c11.z;
            v.w = r.w00 * c00.w + r.w01 * c01.w + r.w10 * c10.w +
                  r.w11 * c11.w;
          }
        }
        const int at = px * kCols + ((4 * q) ^ swz(px));
        *reinterpret_cast<float4*>(sc + at) = v;
      }
    } else {
      for (int j = 0; j < kCols / (kThreads / kPix); ++j) {
        const int col = tid / kPix + j * (kThreads / kPix);
        const int ci = cb * kCols + col;
        float v = 0.f;
        if (ci < a.C) {
          const int g = ci / Cg;
          const float* og = ob + (g - g_first) * 2 * kPix + px;
          const Corners r = corners(yb + og[0], xb0 + og[kPix], a.H, a.W);
          const float* xc = xb + (size_t)g * HW * Cg + (ci - g * Cg);
          v = r.w00 * __ldg(xc + (size_t)r.i00 * Cg) +
              r.w01 * __ldg(xc + (size_t)r.i01 * Cg) +
              r.w10 * __ldg(xc + (size_t)r.i10 * Cg) +
              r.w11 * __ldg(xc + (size_t)r.i11 * Cg);
        }
        const int at = px * kCols + (col ^ swz(px));
        sc[at] = v;
      }
    }
  };

  float acc[4][4] = {};
  // stage (b): S[c & 1] . W -> acc; this warp's 16 pixels, 4 n8 tiles
  auto contract = [&](int c) {
    const int cb = c % ncb;
    const int nks = (min(kCols, a.C - cb * kCols) + 7) / 8;
    // ldmatrix rows: lanes 0-7 rows 0-7 and lanes 8-15 rows 8-15 of the
    // warp's 16 at columns 0-3 of the k step, lanes 16-31 the same at
    // columns 4-7; that is a0 (row g, k t), a1 (g+8, t), a2 (g, t+4), a3
    // (g+8, t+4) of the tf32 A fragment
    const int lrow = warp * 16 + (lane & 15);
    const int lcol = (lane >> 4) * 4;
    const uint32_t sa =
        smem_addr(samp + (c & 1) * kPix * kCols + lrow * kCols);
    const float4* wd = wf + (c % 3) * kWFrag + lane;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t ah[4], al[4];   // S, then its hi and lo parts
      ldmatrix_x4(sa + ((ks * 8 + lcol) ^ swz(lrow)) * 4, ah);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = __uint_as_float(ah[r]);
        ah[r] = tf32(v);
        al[r] = tf32(v - __uint_as_float(ah[r]));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 bw = wd[(ks * 4 + nt) * 32];
        if (kSkip & 2) {   // keep the operands' loads live
          acc[nt][0] +=
              bw.x + __uint_as_float(ah[0]) + __uint_as_float(al[1]);
          continue;
        }
        const uint32_t bh0 = __float_as_uint(bw.x);
        const uint32_t bh1 = __float_as_uint(bw.y);
        mma_tf32(acc[nt], al, bh0, bh1);
        mma_tf32(acc[nt], ah, __float_as_uint(bw.z), __float_as_uint(bw.w));
        mma_tf32(acc[nt], ah, bh0, bh1);
      }
    }
  };

  load(0);
  cp_commit();
  if (nc > 1) load(1);
  cp_commit();
  cp_wait<1>();          // chunk 0's offsets and weights are in
  __syncthreads();
  sample(0);
  for (int c = 0; c < nc; ++c) {
    cp_wait<0>();        // chunk c + 1's offsets and weights are in
    // chunk c's samples, chunk c + 1's offsets are visible; chunk c - 1's
    // samples, offsets and weights are free
    __syncthreads();
    if (c + 2 < nc) load(c + 2);
    cp_commit();
    if (c + 1 < nc) sample(c + 1);
    contract(c);
  }

  // acc[nt]: 0 (pixel g, co 2t), 1 (g, 2t+1), 2 (g+8, 2t), 3 (g+8, 2t+1)
  float* ob = a.out + (size_t)b * a.cout * HW;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int px = warp * 16 + g8 + (r >> 1) * 8;
      const int y = ty0 + px / kTW, x = tx0 + px % kTW;
      const int co = co0 + nt * 8 + 2 * t4 + (r & 1);
      if (y < a.H && x < a.W && co < a.cout) {
        ob[(size_t)co * HW + y * a.W + x] = acc[nt][r];
      }
    }
  }
}

template <int kCg, int kVec>
int launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per device (a host call
  // that would otherwise delay every launch)
  static size_t smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem_set[dev] < smem)) {
    err = cudaFuncSetAttribute(deform_conv_tf32_kernel<kCg, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  deform_conv_tf32_kernel<kCg, kVec><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 --

constexpr int kSStride = kCols + 8;   // bf16 values a sample row
constexpr int kWFragB = 2 * 4 * 32;   // uint2 B fragments a chunk

size_t smem_bytes_bf16(int ngc) {
  return (size_t)3 * kWFragB * 8 + (size_t)2 * kPix * kSStride * 2 +
         (size_t)2 * 2 * ngc * kPix * 4;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The prologue of the bf16 variant: x (B, C, HW) bf16 -> (B, G, HW, Cg)
// bf16; the weights as m16n8k16 B fragments, one uint2 (b0, b1) per
// (output-channel tile z, chunk, k step ks of 16, n8 tile, lane): b0 =
// (W[co][ci], W[co][ci + 1]), b1 = (W[co][ci + 8], W[co][ci + 9]) with co =
// z*32 + nt*8 + lane/4, ci = cb*32 + ks*16 + 2*(lane%4); zero past C and
// Cout.
__global__ void __launch_bounds__(256)
deform_prep_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ xg,
                        const __nv_bfloat16* __restrict__ w,
                        uint2* __restrict__ wfrag, int HW, int Cg,
                        int x_total, int C, int cout, int ncb, int w_total) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < x_total) {
    const int bg = i / HW;      // b * G + g
    const int p = i - bg * HW;
    const __nv_bfloat16* src = x + (size_t)bg * Cg * HW + p;
    __nv_bfloat16* dst = xg + (size_t)i * Cg;
    for (int c = 0; c < Cg; ++c) dst[c] = src[(size_t)c * HW];
    return;
  }
  i -= x_total;
  if (i >= w_total) return;
  const int ln = i & 31, nt = (i >> 5) & 3, ks = (i >> 7) & 1;
  const int chunk = (i >> 8) % (kTaps * ncb);
  const int z = (i >> 8) / (kTaps * ncb);
  const int k = chunk / ncb, cb = chunk - k * ncb;
  const int co = z * kN + nt * 8 + (ln >> 2);
  const int ci = cb * kCols + ks * 16 + 2 * (ln & 3);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = ci + (j & 1) + (j >> 1) * 8;
    v[j] = co < cout && c < C
        ? __bfloat162float(w[((size_t)co * C + c) * kTaps + k]) : 0.f;
  }
  wfrag[i] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// One sample's corners with JAX's bf16 weights: fy, fx = bf16(fraction),
// wy0, wx0 = bf16(1 - f); a corner outside the image has a zero flag.
struct BlendBf16 {
  int i00, i01, i10, i11;
  float v00, v01, v10, v11;   // 1 inside, 0 outside
  float fy, wy0, fx, wx0;
};

__device__ __forceinline__ BlendBf16 blend_bf16(float ys, float xs, int H,
                                                int W) {
  // as in corners(): clamping far-outside coordinates changes nothing
  ys = fminf(fmaxf(ys, -2.f), (float)H + 1.f);
  xs = fminf(fmaxf(xs, -2.f), (float)W + 1.f);
  const float y0f = floorf(ys), x0f = floorf(xs);
  BlendBf16 r;
  r.fy = bf16r(ys - y0f);
  r.fx = bf16r(xs - x0f);
  r.wy0 = bf16r(1.f - r.fy);
  r.wx0 = bf16r(1.f - r.fx);
  const int y0 = (int)y0f, x0 = (int)x0f;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y0 + 1, 0), H - 1);
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x0 + 1, 0), W - 1);
  r.v00 = vy0 && vx0 ? 1.f : 0.f;
  r.v01 = vy0 && vx1 ? 1.f : 0.f;
  r.v10 = vy1 && vx0 ? 1.f : 0.f;
  r.v11 = vy1 && vx1 ? 1.f : 0.f;
  r.i00 = yc0 * W + xc0;
  r.i01 = yc0 * W + xc1;
  r.i10 = yc1 * W + xc0;
  r.i11 = yc1 * W + xc1;
  return r;
}

// JAX's sample from the four corner values (bf16, widened): the rows
// blended at each corner column, then the columns, each rounded to bf16.
__device__ __forceinline__ float sample_bf16(const BlendBf16& r, float c00,
                                             float c01, float c10,
                                             float c11) {
  const float r0 = bf16r(r.wy0 * (c00 * r.v00) + r.fy * (c10 * r.v10));
  const float r1 = bf16r(r.wy0 * (c01 * r.v01) + r.fy * (c11 * r.v11));
  return bf16r(r.wx0 * r0 + r.fx * r1);
}

__device__ __forceinline__ void unpack4(uint2 v, float* f) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  f[0] = __low2float(a);
  f[1] = __high2float(a);
  f[2] = __low2float(b);
  f[3] = __high2float(b);
}

struct ArgsBf16 {
  const __nv_bfloat16* xg;   // (B, G, HW, Cg)
  const float* off;          // (B, G * 18, HW)
  const uint2* wfrag;        // B fragments, see deform_prep_bf16_kernel
  float* out;                // (B, Cout, HW)
  int C, H, W, G, Cg, cout, pad, ngc;
};

// kCg: 4 (TRACE) or 0 (read at run time); Cg % 4 == 0 gathers 8-byte
// quads, other Cg scalars. kVec: floats per cp.async of the offsets.
template <int kCg, int kVec>
__global__ void __launch_bounds__(kThreads, 3)
deform_conv_bf16_kernel(ArgsBf16 a) {
  extern __shared__ float4 smem4[];
  uint2* wf = reinterpret_cast<uint2*>(smem4);               // [3][kWFragB]
  __nv_bfloat16* samp =
      reinterpret_cast<__nv_bfloat16*>(wf + 3 * kWFragB);   // [2][kPix][40]
  float* obuf = reinterpret_cast<float*>(samp + 2 * kPix * kSStride);

  const int Cg = kCg ? kCg : a.Cg;
  const bool quad = Cg % 4 == 0;
  const int HW = a.H * a.W;
  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int ty0 = blockIdx.x / tiles_w * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * kN;
  const int ncb = (a.C + kCols - 1) / kCols;
  const int nc = kTaps * ncb;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const float* offb = a.off + (size_t)b * a.G * 2 * kTaps * HW;
  const __nv_bfloat16* xb = a.xg + (size_t)b * a.G * HW * Cg;
  const uint2* wsrc = a.wfrag + (size_t)blockIdx.z * nc * kWFragB;

  auto load = [&](int c) {
    const int k = c / ncb, cb = c - k * ncb;
    const int g_first = cb * kCols / Cg;
    const int g_last = (min(a.C, cb * kCols + kCols) - 1) / Cg;
    float* dst = obuf + (c & 1) * 2 * a.ngc * kPix;
    const int per_plane = kPix / kVec;
    const int n = (g_last - g_first + 1) * 2 * per_plane;
    for (int i = tid; i < n; i += kThreads) {
      const int plane = i / per_plane;
      const int e = (i - plane * per_plane) * kVec;
      const int ch = ((g_first + plane / 2) * kTaps + k) * 2 + (plane & 1);
      const int y = ty0 + e / kTW, x = tx0 + e % kTW;
      const bool ok = y < a.H && x < a.W;
      cp_async<4 * kVec>(smem_addr(dst + plane * kPix + e),
                         ok ? offb + (size_t)ch * HW + y * a.W + x : a.off,
                         ok);
    }
    for (int i = tid; i < kWFragB / 2; i += kThreads) {   // 16 B a copy
      cp_async<16>(smem_addr(wf + (c % 3) * kWFragB + 2 * i),
                   wsrc + (size_t)c * kWFragB + 2 * i, true);
    }
  };

  auto sample = [&](int c) {
    const int k = c / ncb, cb = c - k * ncb;
    const int ky = k / 3, kx = k - ky * 3;
    const int g_first = cb * kCols / Cg;
    const float* ob = obuf + (c & 1) * 2 * a.ngc * kPix;
    __nv_bfloat16* sc = samp + (c & 1) * kPix * kSStride;
    const int px = tid % kPix;
    const float yb = (float)(ty0 + px / kTW + ky - a.pad);
    const float xb0 = (float)(tx0 + px % kTW + kx - a.pad);
    if (quad) {
#pragma unroll
      for (int j = 0; j < kCols / 4 / (kThreads / kPix); ++j) {
        const int q = tid / kPix + j * (kThreads / kPix);
        const int ci = cb * kCols + 4 * q;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if (ci < a.C) {
          const int g = ci / Cg;
          const float* og = ob + (g - g_first) * 2 * kPix + px;
          const BlendBf16 r =
              blend_bf16(yb + og[0], xb0 + og[kPix], a.H, a.W);
          const uint2* xq = reinterpret_cast<const uint2*>(
              xb + (size_t)g * HW * Cg + (ci - g * Cg));
          const int st = Cg / 4;
          float c00[4], c01[4], c10[4], c11[4];
          unpack4(__ldg(xq + (size_t)r.i00 * st), c00);
          unpack4(__ldg(xq + (size_t)r.i01 * st), c01);
          unpack4(__ldg(xq + (size_t)r.i10 * st), c10);
          unpack4(__ldg(xq + (size_t)r.i11 * st), c11);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[e] = sample_bf16(r, c00[e], c01[e], c10[e], c11[e]);
          }
        }
        *reinterpret_cast<uint2*>(sc + px * kSStride + 4 * q) =
            make_uint2(pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]));
      }
    } else {
      for (int j = 0; j < kCols / (kThreads / kPix); ++j) {
        const int col = tid / kPix + j * (kThreads / kPix);
        const int ci = cb * kCols + col;
        float v = 0.f;
        if (ci < a.C) {
          const int g = ci / Cg;
          const float* og = ob + (g - g_first) * 2 * kPix + px;
          const BlendBf16 r =
              blend_bf16(yb + og[0], xb0 + og[kPix], a.H, a.W);
          const __nv_bfloat16* xc = xb + (size_t)g * HW * Cg + (ci - g * Cg);
          v = sample_bf16(r, __bfloat162float(xc[(size_t)r.i00 * Cg]),
                          __bfloat162float(xc[(size_t)r.i01 * Cg]),
                          __bfloat162float(xc[(size_t)r.i10 * Cg]),
                          __bfloat162float(xc[(size_t)r.i11 * Cg]));
        }
        sc[px * kSStride + col] = __float2bfloat16_rn(v);
      }
    }
  };

  float acc[4][4] = {};
  // S[c & 1] . W -> acc: this warp's 16 pixels, 4 n8 tiles, k steps of 16
  auto contract = [&](int c) {
    const int cb = c % ncb;
    const int nks = (min(kCols, a.C - cb * kCols) + 15) / 16;
    // ldmatrix: lanes 0-15 rows 0-15 at k 0, lanes 16-31 the same at k 8:
    // a0 (rows 0-7, k 0-7), a1 (8-15, 0-7), a2 (0-7, 8-15), a3 (8-15, 8-15)
    const uint32_t sa = smem_addr(samp + (c & 1) * kPix * kSStride +
                                  (warp * 16 + (lane & 15)) * kSStride +
                                  (lane >> 4) * 8);
    const uint2* wd = wf + (c % 3) * kWFragB + lane;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(sa + ks * 16 * 2, af);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint2 bw = wd[(ks * 4 + nt) * 32];
        mma_bf16(acc[nt], af, bw.x, bw.y);
      }
    }
  };

  load(0);
  cp_commit();
  if (nc > 1) load(1);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  sample(0);
  for (int c = 0; c < nc; ++c) {
    cp_wait<0>();
    __syncthreads();
    if (c + 2 < nc) load(c + 2);
    cp_commit();
    if (c + 1 < nc) sample(c + 1);
    contract(c);
  }

  float* ob = a.out + (size_t)b * a.cout * HW;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int px = warp * 16 + g8 + (r >> 1) * 8;
      const int y = ty0 + px / kTW, x = tx0 + px % kTW;
      const int co = co0 + nt * 8 + 2 * t4 + (r & 1);
      if (y < a.H && x < a.W && co < a.cout) {
        ob[(size_t)co * HW + y * a.W + x] = acc[nt][r];
      }
    }
  }
}

template <int kCg, int kVec>
int launch_bf16(const ArgsBf16& a, dim3 grid, size_t smem,
                cudaStream_t stream) {
  // 43,008 bytes at TRACE's shape; past 48 KB (many groups of one
  // channel) the limit is raised once per device, as for the f32 kernel
  static size_t smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem_set[dev] < smem)) {
    err = cudaFuncSetAttribute(deform_conv_bf16_kernel<kCg, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  deform_conv_bf16_kernel<kCg, kVec><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ backward --
//
// The backward of the f32 deform (romp_deform_conv2d_bwd_f32). Replaces
// romp_tpu/ops/pallas_deform.py::_fast_bwd, the VJP of the XLA
// deform_conv2d (romp_tpu/ops/deform_conv.py:43). With S[b, ci, k, p] the
// bilinear sample of channel ci at tap k (zero outside, each corner checked
// on its own) and gcol[b, ci, k, p] = sum_o W[o, ci, k] * gout[b, o, p]:
//   dx[b, ci, corner] += w_corner * gcol            (a scatter)
//   doff[b, (g*9 + k)*2 + {0: dy, 1: dx}, p] = sum_{c of g} gcol * dS/d{y,x}
//   dW[o, ci, k] = sum_{b, p} gout[b, o, p] * S[b, ci, k, p]
// dS/dy is the difference of the two rows' corner values, blended by the x
// weights, and dS/dx the other way round; floor has no gradient, as in
// JAX's one-hot formulation.
//
// What bounds it, at the train step's clip (B = T = 10, C = Cout = 32,
// 128 x 128, G = 8): x 21.0 MB, offsets 94.4 MB and gout 21.0 MB read,
// dx 21.0 MB and doffsets 94.4 MB written, 252 MB: 0.075 ms at 3.35 TB/s.
// The two contractions (gcol and dW) are 3.0 GFLOP each: 0.090 ms on the
// CUDA cores in f32, as this kernel does them, so operations bind; on the
// tensor cores in split TF32 they would take 0.037 ms and bytes would bind.
//
// Design (a simple kernel first; no tensor cores):
// - pass A (deform_bwd_input_kernel): one thread per (b, tap, pixel). A
//   CTA's 256 pixels share b and the tap; gout[b, :, pixels] and W[:, :,
//   tap] sit in shared memory. For each group the thread forms gcol of the
//   group's channels one at a time, gathers the four corners from x (NCHW),
//   accumulates the group's two offset gradients (each owned by one thread:
//   no atomics, one store each) and scatters dx with atomicAdd, as mmcv's
//   CUDA kernel does (a scatter from arbitrary offsets has no gather form).
//   dx's sums therefore come in no fixed order: its last bits vary from
//   run to run.
// - pass B (deform_bwd_weight_kernel): a CTA takes 32 output x 32 input
//   channels (all of them at TRACE's shape) over kBwdSub x 128 pixels of
//   one frame. Per 128 pixels it stages gout (32 x 128) in shared memory
//   and, tap by tap, the samples S (128 pixels x 32 channels, XOR-swizzled
//   rows); each thread accumulates a 1 x 4 block of dW for all nine taps in
//   registers, and the CTA writes its partial sums.
//   deform_bwd_weight_reduce_kernel adds the tiles' partials in a fixed
//   order: no float atomics, so dW is bit-equal from run to run.
constexpr int kBwdPix = 256;              // pass A: pixels per CTA
constexpr int kBwdSub = 8;                // pass B: 128-pixel sub-tiles
constexpr int kBwdTile = kBwdSub * 128;   // pass B: pixels per CTA

// A sample's corners for the backward: clamped indices, the fractions and
// their complements, and each corner's inside flag.
struct GradCorners {
  int i00, i01, i10, i11;
  float ly, lx, hy, hx;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ GradCorners grad_corners(float ys, float xs,
                                                    int H, int W) {
  // as in corners(): a far-outside sample keeps all four corners outside,
  // so its gradients stay zero
  ys = fminf(fmaxf(ys, -2.f), (float)H + 1.f);
  xs = fminf(fmaxf(xs, -2.f), (float)W + 1.f);
  const float y0f = floorf(ys), x0f = floorf(xs);
  GradCorners r;
  r.ly = ys - y0f;
  r.lx = xs - x0f;
  r.hy = 1.f - r.ly;
  r.hx = 1.f - r.lx;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  r.v00 = vy0 && vx0;
  r.v01 = vy0 && vx1;
  r.v10 = vy1 && vx0;
  r.v11 = vy1 && vx1;
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y0 + 1, 0), H - 1);
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x0 + 1, 0), W - 1);
  r.i00 = yc0 * W + xc0;
  r.i01 = yc0 * W + xc1;
  r.i10 = yc1 * W + xc0;
  r.i11 = yc1 * W + xc1;
  return r;
}

size_t bwd_input_smem(int C, int cout) {
  return (size_t)cout * (kBwdPix + C) * 4;
}

// pass A: grid (ceil(HW / 256), B * 9); dx zeroed before
__global__ void __launch_bounds__(kBwdPix)
deform_bwd_input_kernel(const float* __restrict__ x,
                        const float* __restrict__ off,
                        const float* __restrict__ w,
                        const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ doff,
                        int C, int H, int W, int G, int cout, int pad) {
  extern __shared__ float bsm[];
  float* gs = bsm;                       // [cout][kBwdPix]
  float* ws = bsm + cout * kBwdPix;      // [cout][C] at this tap
  const int HW = H * W;
  const int b = blockIdx.y / kTaps, k = blockIdx.y % kTaps;
  const int p0 = blockIdx.x * kBwdPix;
  const int tid = threadIdx.x;
  const float* gb = gout + (size_t)b * cout * HW;
  for (int i = tid; i < cout * kBwdPix; i += kBwdPix) {
    const int o = i / kBwdPix, q = p0 + i % kBwdPix;
    gs[i] = q < HW ? __ldg(gb + (size_t)o * HW + q) : 0.f;
  }
  for (int i = tid; i < cout * C; i += kBwdPix) {
    ws[i] = __ldg(w + (size_t)i * kTaps + k);
  }
  __syncthreads();
  const int p = p0 + tid;
  if (p >= HW) return;
  const int Cg = C / G;
  const float yb = (float)(p / W + k / 3 - pad);
  const float xb = (float)(p % W + k % 3 - pad);
  const size_t off_b = (size_t)b * G * 2 * kTaps * HW + p;
  const float* xbat = x + (size_t)b * C * HW;
  float* dxbat = dx + (size_t)b * C * HW;
  for (int g = 0; g < G; ++g) {
    const size_t ch = (size_t)(g * kTaps + k) * 2;
    const GradCorners r =
        grad_corners(yb + __ldg(off + off_b + ch * HW),
                     xb + __ldg(off + off_b + (ch + 1) * HW), H, W);
    float dly = 0.f, dlx = 0.f;
    for (int c = 0; c < Cg; ++c) {
      const int ci = g * Cg + c;
      float gc = 0.f;
#pragma unroll 8
      for (int o = 0; o < cout; ++o) {
        gc += ws[o * C + ci] * gs[o * kBwdPix + tid];
      }
      const float* xc = xbat + (size_t)ci * HW;
      const float v00 = r.v00 ? __ldg(xc + r.i00) : 0.f;
      const float v01 = r.v01 ? __ldg(xc + r.i01) : 0.f;
      const float v10 = r.v10 ? __ldg(xc + r.i10) : 0.f;
      const float v11 = r.v11 ? __ldg(xc + r.i11) : 0.f;
      dly += gc * (r.hx * (v10 - v00) + r.lx * (v11 - v01));
      dlx += gc * (r.hy * (v01 - v00) + r.ly * (v11 - v10));
      float* dxc = dxbat + (size_t)ci * HW;
      if (r.v00) atomicAdd(dxc + r.i00, r.hy * r.hx * gc);
      if (r.v01) atomicAdd(dxc + r.i01, r.hy * r.lx * gc);
      if (r.v10) atomicAdd(dxc + r.i10, r.ly * r.hx * gc);
      if (r.v11) atomicAdd(dxc + r.i11, r.ly * r.lx * gc);
    }
    doff[off_b + ch * HW] = dly;
    doff[off_b + (ch + 1) * HW] = dlx;
  }
}

// pass B: grid (tiles = ceil(HW / kBwdTile), B, ceil(cout/32) *
// ceil(C/32)); partial[(b * tiles + tile)][co][ci][k]
__global__ void __launch_bounds__(256)
deform_bwd_weight_kernel(const float* __restrict__ x,
                         const float* __restrict__ off,
                         const float* __restrict__ gout,
                         float* __restrict__ partial, int C, int H, int W,
                         int G, int cout, int pad) {
  __shared__ float gs[32][129];                  // gout, padded rows
  __shared__ __align__(16) float ss[128 * 32];   // S, swizzled rows
  const int HW = H * W;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ncb = (C + 31) / 32;
  const int co0 = (blockIdx.z / ncb) * 32, ci0 = (blockIdx.z % ncb) * 32;
  const int tid = threadIdx.x;
  const int Cg = C / G;
  const int co_l = tid >> 3, cq = (tid & 7) * 4;   // this thread's dW block
  const int px = tid & 127, half = tid >> 7;       // its samples
  const float* gb = gout + (size_t)b * cout * HW;
  const float* offb = off + (size_t)b * G * 2 * kTaps * HW;
  const float* xbat = x + (size_t)b * C * HW;
  float acc[kTaps][4] = {};
  for (int s = 0; s < kBwdSub; ++s) {
    const int p0 = tile * kBwdTile + s * 128;
    if (p0 >= HW) break;            // the same for the whole CTA
    __syncthreads();                // the last sub-tile's reads are done
    for (int i = tid; i < 32 * 128; i += 256) {
      const int o = i >> 7, q = p0 + (i & 127);
      gs[o][i & 127] = co0 + o < cout && q < HW
          ? __ldg(gb + (size_t)(co0 + o) * HW + q) : 0.f;
    }
    const int p = p0 + px;
    const bool in = p < HW;
    const int py = in ? p / W : 0, pxx = in ? p % W : 0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float yb = (float)(py + k / 3 - pad);
      const float xb = (float)(pxx + k % 3 - pad);
      __syncthreads();              // the last tap's S is read
      // this thread's 16 columns, half * 16 on; the corners once a group
      int last_g = -1;
      Corners r{};
      for (int col = half * 16; col < half * 16 + 16; ++col) {
        const int ci = ci0 + col;
        float v = 0.f;
        if (in && ci < C) {
          const int g = ci / Cg;
          if (g != last_g) {
            const size_t ch = (size_t)(g * kTaps + k) * 2;
            r = corners(yb + __ldg(offb + ch * HW + p),
                        xb + __ldg(offb + (ch + 1) * HW + p), H, W);
            last_g = g;
          }
          const float* xc = xbat + (size_t)ci * HW;
          v = r.w00 * __ldg(xc + r.i00) + r.w01 * __ldg(xc + r.i01) +
              r.w10 * __ldg(xc + r.i10) + r.w11 * __ldg(xc + r.i11);
        }
        ss[px * 32 + (col ^ swz(px))] = v;
      }
      __syncthreads();              // S and gout are in
      const float* grow = gs[co_l];
#pragma unroll 4
      for (int q = 0; q < 128; ++q) {
        const float gv = grow[q];
        const float4 sv =
            *reinterpret_cast<const float4*>(ss + q * 32 + (cq ^ swz(q)));
        acc[k][0] += gv * sv.x;
        acc[k][1] += gv * sv.y;
        acc[k][2] += gv * sv.z;
        acc[k][3] += gv * sv.w;
      }
    }
  }
  float* pt = partial + (size_t)(b * gridDim.x + tile) * cout * C * kTaps;
  const int co = co0 + co_l;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + cq + j;
      if (co < cout && ci < C) pt[((size_t)co * C + ci) * kTaps + k] = acc[k][j];
    }
  }
}

// dW[e] = sum over the tiles, in order, of partial[tile][e]
__global__ void deform_bwd_weight_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int n,
    int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += partial[(size_t)t * n + i];
  dw[i] = s;
}

}  // namespace

// x (b, c, h, w), off (b, g*2*9, h, w), w (cout, c, 3, 3) -> out
// (b, cout, h, w), all f32 and contiguous; scratch: 16-byte aligned, of
// ceil(cout/32) * 9 * ceil(c/32) * 512 * 4 (the weight fragments) +
// b*c*h*w (x regrouped) floats (ops/deform_conv.py `scratch_floats`).
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for shapes
// the kernel does not take).
extern "C" int romp_deform_conv2d_f32(const float* x, const float* off,
                                      const float* w, float* out,
                                      float* scratch, int b, int c, int h,
                                      int wd, int g, int cout, int pad,
                                      cudaStream_t stream) {
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || g <= 0 || cout <= 0 ||
      c % g != 0 || b > 65535 || (cout + kN - 1) / kN > 65535 ||
      (long long)b * h * wd * c >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cg = c / g;
  const int hw = h * wd;
  const int ncb = (c + kCols - 1) / kCols;
  const int x_total = b * g * hw;
  const int w_total = (cout + kN - 1) / kN * kTaps * ncb * kWFrag;
  float4* wfrag = reinterpret_cast<float4*>(scratch);
  float* xg = scratch + (size_t)w_total * 4;   // stays 16-byte aligned
  const int ngc = g < (kCols - 1) / cg + 2 ? g : (kCols - 1) / cg + 2;
  const size_t smem = smem_bytes(ngc);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  deform_prep_kernel<<<(x_total + w_total + 255) / 256, 256, 0, stream>>>(
      x, xg, w, wfrag, hw, cg, x_total, c, cout, ncb, w_total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const Args a{xg, off, wfrag, out, c, h, wd, g, cg, cout, pad, ngc};
  const dim3 grid(((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW), b,
                  (cout + kN - 1) / kN);
  const bool vec = wd % 4 == 0 && reinterpret_cast<uintptr_t>(off) % 16 == 0;
  if (cg == 4) {
    return vec ? launch<4, 4>(a, grid, smem, stream)
               : launch<4, 1>(a, grid, smem, stream);
  }
  return vec ? launch<0, 4>(a, grid, smem, stream)
             : launch<0, 1>(a, grid, smem, stream);
}

// The bf16 variant (see the header): x (b, c, h, w) and w (cout, c, 3, 3)
// bf16, off (b, g*2*9, h, w) f32 -> out (b, cout, h, w) f32, all
// contiguous; scratch: 16-byte aligned, ceil(cout/32) * 9 * ceil(c/32) *
// 256 * 8 bytes of weight fragments, then b*c*h*w bf16 values of x
// regrouped (ops/deform_conv.py `scratch_bytes_bf16`).
extern "C" int romp_deform_conv2d_bf16(const void* x, const float* off,
                                       const void* w, float* out,
                                       void* scratch, int b, int c, int h,
                                       int wd, int g, int cout, int pad,
                                       cudaStream_t stream) {
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || g <= 0 || cout <= 0 ||
      c % g != 0 || b > 65535 || (cout + kN - 1) / kN > 65535 ||
      (long long)b * h * wd * c >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cg = c / g;
  const int hw = h * wd;
  const int ncb = (c + kCols - 1) / kCols;
  const int x_total = b * g * hw;
  const int w_total = (cout + kN - 1) / kN * kTaps * ncb * kWFragB;
  uint2* wfrag = reinterpret_cast<uint2*>(scratch);
  auto* xg = reinterpret_cast<__nv_bfloat16*>(wfrag + w_total);
  const int ngc = g < (kCols - 1) / cg + 2 ? g : (kCols - 1) / cg + 2;
  const size_t smem = smem_bytes_bf16(ngc);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  deform_prep_bf16_kernel<<<(x_total + w_total + 255) / 256, 256, 0,
                            stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), xg,
      reinterpret_cast<const __nv_bfloat16*>(w), wfrag, hw, cg, x_total, c,
      cout, ncb, w_total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const ArgsBf16 a{xg, off, wfrag, out, c, h, wd, g, cg, cout, pad, ngc};
  const dim3 grid(((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW), b,
                  (cout + kN - 1) / kN);
  const bool vec = wd % 4 == 0 && reinterpret_cast<uintptr_t>(off) % 16 == 0;
  if (cg == 4) {
    return vec ? launch_bf16<4, 4>(a, grid, smem, stream)
               : launch_bf16<4, 1>(a, grid, smem, stream);
  }
  return vec ? launch_bf16<0, 4>(a, grid, smem, stream)
             : launch_bf16<0, 1>(a, grid, smem, stream);
}

// The backward (see its header above): x (b, c, h, w), off (b, g*2*9, h,
// w), w (cout, c, 3, 3) and gout (b, cout, h, w), f32 and contiguous ->
// dx (b, c, h, w), doff (b, g*2*9, h, w), dw (cout, c, 3, 3); scratch
// `partial`: b * ceil(h*w / 1024) * cout * c * 9 floats (ops/deform_conv.py
// `bwd_partial_floats`). dx is zeroed here. Returns the cudaError_t of the
// launches (cudaErrorInvalidValue for shapes the kernels do not take).
extern "C" int romp_deform_conv2d_bwd_f32(const float* x, const float* off,
                                          const float* w, const float* gout,
                                          float* dx, float* doff, float* dw,
                                          float* partial, int b, int c,
                                          int h, int wd, int g, int cout,
                                          int pad, cudaStream_t stream) {
  const size_t smem = bwd_input_smem(c, cout);
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || g <= 0 || cout <= 0 ||
      c % g != 0 || (long long)b * kTaps > 65535 ||
      (long long)((cout + 31) / 32) * ((c + 31) / 32) > 65535 ||
      (long long)b * h * wd * (c > cout ? c : cout) >= (1ll << 31) ||
      (long long)b * h * wd * g * 2 * kTaps >= (1ll << 31) ||
      smem > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const int hw = h * wd;
  cudaError_t err =
      cudaMemsetAsync(dx, 0, (size_t)b * c * hw * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  static size_t smem_set[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem_set[dev] < smem)) {
    err = cudaFuncSetAttribute(deform_bwd_input_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  deform_bwd_input_kernel<<<dim3((hw + kBwdPix - 1) / kBwdPix, b * kTaps),
                            kBwdPix, smem, stream>>>(x, off, w, gout, dx,
                                                     doff, c, h, wd, g, cout,
                                                     pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (hw + kBwdTile - 1) / kBwdTile;
  deform_bwd_weight_kernel<<<dim3(tiles, b,
                                  ((cout + 31) / 32) * ((c + 31) / 32)),
                             256, 0, stream>>>(x, off, gout, partial, c, h,
                                               wd, g, cout, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = cout * c * kTaps;
  deform_bwd_weight_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      partial, dw, n, b * tiles);
  return (int)cudaGetLastError();
}
