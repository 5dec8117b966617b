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
// element i = (b * G + g) * HW + p of x (B, C, HW) regrouped: x[b, g*Cg +
// c, p] -> xg[i * Cg + c]
__device__ __forceinline__ void regroup_x(const float* __restrict__ x,
                                          float* __restrict__ xg, int i,
                                          int HW, int Cg) {
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
}

__global__ void __launch_bounds__(256)
deform_prep_kernel(const float* __restrict__ x, float* __restrict__ xg,
                   const float* __restrict__ w, float4* __restrict__ wfrag,
                   int HW, int Cg, int x_total, int C, int cout, int ncb,
                   int w_total) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < x_total) {
    regroup_x(x, xg, i, HW, Cg);
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
// The two contractions (gcol and dW) are 3.0 GFLOP each, 0.037 ms on the
// tensor cores in split TF32, so bytes bind. PR 8's two-pass CUDA-core
// kernel took 2.8 ms, 45% of it in 188.7 M scalar global atomics for dx
// and 35% in its second pass (dW on the CUDA cores, x gathered again);
// it also read the offsets twice (PERF.md).
//
// Design: one pass over the data.
// - A prologue (deform_bwd_prep_kernel) writes x as (B, G, H*W, Cg), as
//   the forward's does, so that a corner's Cg = 4 channels are one
//   16-byte load; zeroes dx; and writes W as split TF32 B fragments for
//   gcol, in the order the MMAs read them.
// - One CTA an SM (16 warps), persistent: CTA i takes the 16 x 8 pixel
//   tiles i, i + grid, ... of all frames, a fixed assignment, so that its
//   dW partial is the same sum every run. Per tile it splits gout's tile
//   (Cout x 128 pixels, the same for every tap) into TF32 hi and lo in
//   shared memory once, then runs the tile's chunks, a chunk being one
//   tap and up to 32 channels of whole groups (a group wider than 32
//   channels takes several chunks, its doffsets summed across them).
//   cp.async brings a chunk's offset planes and weight fragments two
//   chunks ahead. Per chunk:
//   (a) gcol (warps 8-15, a warp 16 pixels x 32 columns): gout^T . W on
//       mma.sync.m16n8k8 with the three products lo.hi + hi.lo + hi.hi
//       (an f32-accurate result; one TF32 product misses the 1e-4 bar),
//       into shared memory (rows XOR-swizzled);
//   (b) dW (warps 0-7, a warp a 16 x 8 block of (Cout, chunk columns)
//       over the 128 pixels): gout . S on the same split-TF32 MMAs, added
//       to the CTA's partial (in shared memory where it fits, else in
//       device memory);
//   (c) sample (all warps, a thread a (pixel, group)): the corners from
//       the offsets; x gathered once, as float4s; the sample S over gcol
//       in place; doffsets stored (one writer each); dx's contributions
//       added to shared-memory windows, those of corners outside them
//       straight to dx by global atomics.
//   Buffers rotate over three chunks, so (a) of chunk c + 1, (b) of c - 1
//   and (c) of c run between the same two barriers, one barrier a chunk.
// - dx. The card's shared f32 atomics are compare-and-swap loops
//   (ATOMS.CAST.SPIN in the SASS), which ran the adds no faster than
//   PR 8's global atomics. So where the channels are one chunk and G is
//   4, 8 or 16 (TRACE: 8), each warp owns a window: its group's channels
//   over its rows of pixels +- 4 rows, the tile's columns +- 4 (4 x 12 x
//   24 floats at TRACE's shape), and adds to it with plain reads and
//   writes. Two lanes' corners meet only where their top-left corners
//   are equal or adjacent: barriers between the four corners order the
//   adjacent ones; equal ones are found by each lane tagging its
//   top-left corner's cell, and a lane whose tag was overwritten adds to
//   dx instead (ops/deform_conv.py `bwd_global_share` counts these with
//   the corners outside the window). Other shapes have no window: every
//   contribution goes to dx by global atomics. At the end of a tile the
//   windows are added to dx with 16-byte vector atomics
//   (red.global.add.v4.f32; scalar where W % 4 != 0).
// - deform_bwd_reduce_kernel adds the CTAs' dW partials in a fixed order:
//   dweight and doffsets are bit-equal from run to run; dx, summed by
//   atomics, varies in its last bits.
// Where the time goes (PERF.md, B = 10): the dx adds a third, the
// contractions a quarter, the gathers a fifth; one CTA of 16 warps an SM
// (the windows, gout's tile and three chunks' buffers take 220 KB)
// leaves the tensor cores and the gathers' latency poorly overlapped.
// Measurement builds only (utils/kernel_breakdown.py): -DROMP_DEFORM_BWD_SKIP=
// mask leaves out the samples' adds to dx (1), the gathers of x (2: the
// corners' weights stand in for the values), the contractions (4: no
// gcol, no dW), the windows' flush into dx (8), or the tags and barriers
// that order a warp's plain adds to its window (16). The results of such
// a build are wrong.
#ifndef ROMP_DEFORM_BWD_SKIP
#define ROMP_DEFORM_BWD_SKIP 0
#endif
constexpr int kBwdSkip = ROMP_DEFORM_BWD_SKIP;
constexpr int kBwdThreads = 512;   // 16 warps: 0-7 dW, 8-15 gcol
constexpr int kGcolWarp0 = 8;

// Chunk cb of a tap: its first channel, width, groups (the first and how
// many), the first channel within the group, and whether it ends the group.
struct BwdChunk {
  int ci0, width, g_first, ng, cg0;
  bool last;
};

int bwd_chunks_a_tap(int C, int Cg) {
  const int G = C / Cg;
  return Cg <= kCols ? (G + kCols / Cg - 1) / (kCols / Cg)
                     : G * ((Cg + kCols - 1) / kCols);
}

__device__ __forceinline__ BwdChunk bwd_chunk(int cb, int C, int Cg) {
  BwdChunk r;
  if (Cg <= kCols) {
    const int gpc = kCols / Cg;
    r.g_first = cb * gpc;
    r.ci0 = r.g_first * Cg;
    r.width = min(gpc * Cg, C - r.ci0);
    r.ng = r.width / Cg;
    r.cg0 = 0;
    r.last = true;
  } else {
    const int per = (Cg + kCols - 1) / kCols;
    r.g_first = cb / per;
    const int j = cb - r.g_first * per;
    r.cg0 = kCols * j;
    r.ci0 = r.g_first * Cg + r.cg0;
    r.width = min(kCols, Cg - r.cg0);
    r.ng = 1;
    r.last = j == per - 1;
  }
  return r;
}

// The prologue: threads below x_total regroup x as deform_prep_kernel does
// and zero dx at the same elements; the others write the split B fragments
// of W for gcol = gout^T . W, one float4 (b0 hi, b1 hi, b0 lo, b1 lo) per
// (chunk c = tap * ncb + cb, k step ks of 8 output channels, n8 tile nt of
// the chunk's columns, lane): b0 = W[o][ci][tap] with o = ks*8 + lane%4,
// ci = ci0 + nt*8 + lane/4, b1 at o + 4; zero past Cout and the chunk.
__global__ void __launch_bounds__(256)
deform_bwd_prep_kernel(const float* __restrict__ x, float* __restrict__ xg,
                       float* __restrict__ dx, const float* __restrict__ w,
                       float4* __restrict__ wfrag, int HW, int Cg,
                       int x_total, int C, int cout, int ncb, int nko,
                       int w_total) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < x_total) {
    regroup_x(x, xg, i, HW, Cg);
    const int bg = i / HW;
    float* d = dx + (size_t)bg * Cg * HW + (i - bg * HW);
    for (int c = 0; c < Cg; ++c) d[(size_t)c * HW] = 0.f;
    return;
  }
  i -= x_total;
  if (i >= w_total) return;
  const int ln = i & 31, nt = (i >> 5) & 3, rest = i >> 7;
  const int ks = rest % nko, c = rest / nko;
  const int k = c / ncb;
  const BwdChunk ch = bwd_chunk(c - k * ncb, C, Cg);
  const int col = nt * 8 + (ln >> 2);
  const int ci = ch.ci0 + col;
  const int o = ks * 8 + (ln & 3);
  const bool in = col < ch.width;
  const float w0 = in && o < cout
      ? __ldg(w + ((size_t)o * C + ci) * kTaps + k) : 0.f;
  const float w1 = in && o + 4 < cout
      ? __ldg(w + ((size_t)(o + 4) * C + ci) * kTaps + k) : 0.f;
  const float h0 = hi_of(w0), h1 = hi_of(w1);
  wfrag[i] = make_float4(h0, h1, lo_of(w0, h0), lo_of(w1, h1));
}

// A sample's corners for the backward: the top-left corner, clamped
// indices, the fractions and their complements, each corner's inside flag.
struct GradCorners {
  int y0, x0;
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
  r.y0 = y0;
  r.x0 = x0;
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

__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

struct BwdArgs {
  const float* xg;      // (B, G, HW, Cg)
  const float* off;     // (B, G * 18, HW)
  const float* gout;    // (B, Cout, HW)
  const float4* wfrag;  // see deform_bwd_prep_kernel
  float* dx;            // (B, C, HW), zeroed by the prologue
  float* doff;          // (B, G * 18, HW)
  float* partial;       // (CTAs, chunks, cout16, 32): the dW partials
  int B, C, H, W, G, Cg, cout, pad;
  int ncb, nko, cout16, ngc;   // chunks a tap, gcol's k steps, Cout to 16,
                               // groups a chunk at most
  int ey, ex, wr, wc;   // the dx windows, one a warp, of its group's
                        // channels: wr rows from its first row - ey, wc
                        // columns from tx0 - ex (wr = wc = 0: none)
  int wrows;            // pixel rows a warp (with windows)
  int dw_smem;          // the dW partial in shared memory (else `partial`)
  int vec_dx;           // W % 4 == 0: the windows flushed by float4s
};

// the floats of the warps' dx windows, and of their tags: an int a cell
// of the window's plane grown by one row and column up and left
__host__ __device__ __forceinline__ int bwd_window_floats(int Cg, int wr,
                                                          int wc) {
  return kBwdThreads / 32 * Cg * wr * wc;
}

__host__ __device__ __forceinline__ int bwd_tag_floats(int wr, int wc) {
  return wr ? kBwdThreads / 32 * (wr + 1) * (wc + 1) : 0;
}

size_t bwd_smem_floats(int cout16, int nko, int ngc, int win_floats,
                       int nc, int dw_smem) {
  return (size_t)2 * cout16 * kPix + 3 * kPix * kCols + 3 * 2 * ngc * kPix +
         (size_t)3 * nko * 128 * 4 + win_floats +
         (dw_smem ? (size_t)nc * cout16 * kCols : 0);
}

// The backward's launch plan (exported as romp_deform_conv2d_bwd_plan):
// `ctas` persistent CTAs (at most one an SM and one a tile); where the
// channels are one chunk and G is 4, 8 or 16, the dx windows of each warp's
// wrows rows of the tile +- ey rows and the tile's columns +- ex, the
// largest of kBwdWindows that fits (ey < 0: none; other shapes have none);
// the dW partial in shared memory (dw_smem) where it fits too. smem in
// bytes; scratch: the floats of the caller's scratch (the weight
// fragments, x regrouped, the CTAs' dW partials). False for shapes whose
// smallest plan does not fit.
struct BwdPlan {
  int ncb, nko, cout16, ngc;
  int ctas, ey, ex, wrows, wr, wc, dw_smem;
  size_t smem;
  long long scratch;
};

constexpr int kBwdWindows[][2] = {{4, 4}, {2, 4}, {0, 4}, {0, 0}, {-1, -1}};

bool bwd_plan(int b, int c, int h, int wd, int g, int cout, int sms,
              BwdPlan* p) {
  const int cg = c / g;
  p->ncb = bwd_chunks_a_tap(c, cg);
  p->nko = (cout + 7) / 8;
  p->cout16 = (cout + 15) / 16 * 16;
  p->ngc = cg <= kCols ? (g < kCols / cg ? g : kCols / cg) : 1;
  const int nc = kTaps * p->ncb;
  const long long tiles =
      (long long)b * ((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW);
  p->ctas = (int)(tiles < sms ? tiles : sms);
  // a window a warp takes one chunk a tap and 16 / G warps a group, each
  // over 8 * G / 16 >= 2 rows of the tile
  const bool own = p->ncb == 1 && (g == 4 || g == 8 || g == 16);
  p->wrows = own ? kTH * g / (kBwdThreads / 32) : kTH;
  for (int i = own ? 0 : 4; i < 5; ++i) {
    p->ey = kBwdWindows[i][0];
    p->ex = kBwdWindows[i][1];
    p->wr = p->ey < 0 ? 0 : p->wrows + 2 * p->ey;
    p->wc = p->ex < 0 ? 0 : kTW + 2 * p->ex;
    for (p->dw_smem = 1; p->dw_smem >= 0; --p->dw_smem) {
      p->smem = 4 * bwd_smem_floats(
          p->cout16, p->nko, p->ngc,
          bwd_window_floats(cg, p->wr, p->wc) + bwd_tag_floats(p->wr, p->wc),
          nc, p->dw_smem);
      if (p->smem <= (size_t)kMaxSmem) {
        p->scratch = (long long)nc * p->nko * 128 * 4 +
                     (long long)b * c * h * wd +
                     (long long)p->ctas * nc * p->cout16 * kCols;
        return true;
      }
    }
  }
  return false;
}

// G (gout's tile, hi and lo) element (o, p) sits at o * kPix + (p ^ gswz(o)):
// ldmatrix's 8 rows at one column quad are conflict-free
__device__ __forceinline__ int gswz(int o) { return (o & 7) << 2; }
// the dW partial's element (o, col) at o * kCols + (col ^ dswz(o))
__device__ __forceinline__ int dswz(int o) { return (o & 3) << 3; }

// kCg: the group width when it is 4 (TRACE), else 0 (read at run time).
// kVec: floats per cp.async of the offset planes (4 where W % 4 == 0).
template <int kCg, int kVec>
__global__ void __launch_bounds__(kBwdThreads, 1)
deform_bwd_tf32_kernel(BwdArgs a) {
  extern __shared__ float4 bsm4[];
  float* ghi = reinterpret_cast<float*>(bsm4);       // [cout16][kPix]
  float* glo = ghi + a.cout16 * kPix;                 // [cout16][kPix]
  float* gs = glo + a.cout16 * kPix;                  // [3][kPix][kCols]
  float* obuf = gs + 3 * kPix * kCols;                // [3][2 * ngc][kPix]
  float4* wbuf = reinterpret_cast<float4*>(obuf + 3 * 2 * a.ngc * kPix);
  const int wfrags = a.nko * 128;                     // float4s a chunk
  const int Cg = kCg ? kCg : a.Cg;
  const int win_floats = bwd_window_floats(Cg, a.wr, a.wc);
  float* win = reinterpret_cast<float*>(wbuf + 3 * wfrags);
  // [warps][Cg][wr][wc], then the tags [warps][wr + 1][wc + 1]
  int* tags = reinterpret_cast<int*>(win + win_floats);
  // [nc][cout16][kCols]
  float* dwa = win + win_floats + bwd_tag_floats(a.wr, a.wc);

  const bool quad = Cg % 4 == 0;
  const int HW = a.H * a.W;
  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int tpf = (a.H + kTH - 1) / kTH * tiles_w;
  const int ntiles = a.B * tpf;
  const int nc = kTaps * a.ncb;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int per_cta = nc * a.cout16 * kCols;
  float* dwacc = a.dw_smem ? dwa : a.partial + (size_t)blockIdx.x * per_cta;
  for (int i = tid; i < win_floats; i += kBwdThreads) win[i] = 0.f;
  for (int i = tid; i < per_cta; i += kBwdThreads) dwacc[i] = 0.f;

  int b = 0, ty0 = 0, tx0 = 0;   // the tile
  float cy = 0.f, cx = 0.f;      // doffsets of a group wider than a chunk

  // chunk c's offset planes (dy, dx of its groups) -> obuf[c % 3], its
  // weight fragments -> wbuf[c % 3]
  auto load = [&](int c) {
    const int k = c / a.ncb;
    const BwdChunk ch = bwd_chunk(c - k * a.ncb, a.C, Cg);
    const float* offb = a.off + (size_t)b * a.G * 2 * kTaps * HW;
    float* dst = obuf + (c % 3) * 2 * a.ngc * kPix;
    const int per_plane = kPix / kVec;
    const int n = ch.ng * 2 * per_plane;
    for (int i = tid; i < n; i += kBwdThreads) {
      const int plane = i / per_plane;
      const int e = (i - plane * per_plane) * kVec;
      const int chn = ((ch.g_first + plane / 2) * kTaps + k) * 2 + (plane & 1);
      const int y = ty0 + e / kTW, x = tx0 + e % kTW;
      const bool ok = y < a.H && x < a.W;   // W % kVec == 0: all in or out
      cp_async<4 * kVec>(smem_addr(dst + plane * kPix + e),
                         ok ? offb + (size_t)chn * HW + y * a.W + x : a.off,
                         ok);
    }
    const float4* wsrc = a.wfrag + (size_t)c * wfrags;
    for (int i = tid; i < wfrags; i += kBwdThreads) {
      cp_async<16>(smem_addr(wbuf + (c % 3) * wfrags + i), wsrc + i, true);
    }
  };

  // (a) gcol of chunk c -> gs[c % 3]: this warp's 16 pixels x 32 columns
  auto gcol = [&](int c) {
    if (kBwdSkip & 4) return;
    const int p0 = (warp - kGcolWarp0) * 16 + g8, p1 = p0 + 8;
    // hi.hi and the two cross products in chains of their own (shorter
    // dependency chains through the MMAs)
    float acc[4][4] = {}, accx[4][4] = {};
    const float4* wd = wbuf + (c % 3) * wfrags + lane;
    for (int ks = 0; ks < a.nko; ++ks) {
      // A = G^T: a0 (pixel g, o t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
      const int o0 = ks * 8 + t4, o1 = o0 + 4;
      const int r0 = o0 * kPix, r1 = o1 * kPix;
      const int s0 = gswz(o0), s1 = gswz(o1);
      const int e[4] = {r0 + (p0 ^ s0), r0 + (p1 ^ s0), r1 + (p0 ^ s1),
                        r1 + (p1 ^ s1)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[r] = __float_as_uint(ghi[e[r]]);
        al[r] = __float_as_uint(glo[e[r]]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 bw = wd[(ks * 4 + nt) * 32];
        const uint32_t bh0 = __float_as_uint(bw.x);
        const uint32_t bh1 = __float_as_uint(bw.y);
        mma_tf32(accx[nt], al, bh0, bh1);
        mma_tf32(accx[nt], ah, __float_as_uint(bw.z), __float_as_uint(bw.w));
        mma_tf32(acc[nt], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] += accx[nt][r];
    }
    // acc[nt]: 0 (pixel g, column 2t), 1 (g, 2t+1), 2 (g+8, 2t), 3 (g+8,
    // 2t+1); the XOR keeps a column pair together
    float* sc = gs + (c % 3) * kPix * kCols;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(sc + p0 * kCols + (col ^ swz(p0))) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(sc + p1 * kCols + (col ^ swz(p1))) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  };

  // (c) chunk c's samples: S over gcol in gs[c % 3], doffsets, dx
  auto sample = [&](int c) {
    const int k = c / a.ncb;
    const int ky = k / 3, kx = k - ky * 3;
    const BwdChunk ch = bwd_chunk(c - k * a.ncb, a.C, Cg);
    const int nch = Cg <= kCols ? Cg : ch.width;   // channels an item
    const float* ob = obuf + (c % 3) * 2 * a.ngc * kPix;
    float* sc = gs + (c % 3) * kPix * kCols;
    const int wplane = a.wr * a.wc;
    float* dxb = a.dx + (size_t)b * a.C * HW;
    // item (pixel p, group gl of the chunk); wb: the window it adds to,
    // whose rows start at wy0 and channels at wci0
    auto item = [&](int p, int gl, float* wb, int* tg, int wy0, int wci0) {
      const int py = ty0 + p / kTW, px = tx0 + p % kTW;
      // outside the image: gcol, so S, stays 0; a warp's lanes stay
      // together for the window's tags below
      const bool live = py < a.H && px < a.W;
      const int g = ch.g_first + gl;
      const GradCorners r =
          grad_corners((float)(py + ky - a.pad) + ob[2 * gl * kPix + p],
                       (float)(px + kx - a.pad) + ob[(2 * gl + 1) * kPix + p],
                       a.H, a.W);
      const bool v[4] = {live && r.v00, live && r.v01, live && r.v10,
                         live && r.v11};
      const float wt[4] = {v[0] ? r.hy * r.hx : 0.f, v[1] ? r.hy * r.lx : 0.f,
                           v[2] ? r.ly * r.hx : 0.f, v[3] ? r.ly * r.lx : 0.f};
      const int idx[4] = {r.i00, r.i01, r.i10, r.i11};
      // corner e's element in the window (pos), where it is in it (in_w)
      const int wr0 = r.y0 - wy0, wc0 = r.x0 - (tx0 - a.ex);
      int pos[4];
      bool in_w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int wrr = wr0 + (e >> 1), wcc = wc0 + (e & 1);
        in_w[e] = wt[e] != 0.f && (unsigned)wrr < (unsigned)a.wr &&
                  (unsigned)wcc < (unsigned)a.wc;
        pos[e] = wrr * a.wc + wcc;
      }
      // In the window, this warp's own, the lanes add with plain reads and
      // writes. Two lanes' corners e and e' meet only where their
      // top-left corners are equal or adjacent: adjacent ones meet at
      // different corners, which barriers between the corners order;
      // equal ones are found by tagging the top-left corner's cell with
      // the lane: a lane whose tag was overwritten sends its adds to dx
      // instead.
      const bool tagged = a.wr && !(kBwdSkip & 16);
      bool owner = true;
      if (tagged) {
        const bool any_in = in_w[0] || in_w[1] || in_w[2] || in_w[3];
        const int cell = (wr0 + 1) * (a.wc + 1) + wc0 + 1;   // >= 0 then
        if (any_in) tg[cell] = lane;
        __syncwarp();
        owner = !any_in || tg[cell] == lane;
      }
      // the n <= 4 contributions val of corner e to channels ci..: to the
      // window, or straight to dx
      auto scatter = [&](int e, int ci, const float* val, int n) {
        if (kBwdSkip & 1 || wt[e] == 0.f) return;
        if (in_w[e] && owner) {
          float* wp = wb + (ci - wci0) * wplane + pos[e];
          float o[4];
          for (int j = 0; j < n; ++j) o[j] = wp[j * wplane];
          for (int j = 0; j < n; ++j) wp[j * wplane] = o[j] + val[j];
        } else {
          float* d = dxb + (size_t)ci * HW + idx[e];
          for (int j = 0; j < n; ++j) atomicAdd(d + (size_t)j * HW, val[j]);
        }
      };
      const float* xgp = a.xg + ((size_t)b * a.G + g) * HW * Cg + ch.cg0;
      const int col0 = gl * nch;
      float dly = 0.f, dlx = 0.f;
      if (quad) {
        for (int q = 0; q < nch; q += 4) {
          const int col = col0 + q;
          float4* sp = reinterpret_cast<float4*>(sc + p * kCols +
                                                 (col ^ swz(p)));
          const float4 gc = *sp;
          float4 cv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cv[e] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (kBwdSkip & 2) {
              cv[e] = make_float4(wt[e], wt[e], wt[e], wt[e]);
            } else if (v[e]) {
              cv[e] = __ldg(reinterpret_cast<const float4*>(
                  xgp + (size_t)idx[e] * Cg + q));
            }
          }
          const float g4[4] = {gc.x, gc.y, gc.z, gc.w};
          const float x00[4] = {cv[0].x, cv[0].y, cv[0].z, cv[0].w};
          const float x01[4] = {cv[1].x, cv[1].y, cv[1].z, cv[1].w};
          const float x10[4] = {cv[2].x, cv[2].y, cv[2].z, cv[2].w};
          const float x11[4] = {cv[3].x, cv[3].y, cv[3].z, cv[3].w};
          float s[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[j] = wt[0] * x00[j] + wt[1] * x01[j] + wt[2] * x10[j] +
                   wt[3] * x11[j];
            dly += g4[j] * (r.hx * (x10[j] - x00[j]) +
                            r.lx * (x11[j] - x01[j]));
            dlx += g4[j] * (r.hy * (x01[j] - x00[j]) +
                            r.ly * (x11[j] - x10[j]));
          }
          if (live) *sp = make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float val[4] = {wt[e] * g4[0], wt[e] * g4[1],
                                  wt[e] * g4[2], wt[e] * g4[3]};
            scatter(e, ch.ci0 + col, val, 4);
            if (tagged && e < 3) __syncwarp();
          }
        }
      } else {
        for (int q = 0; q < nch; ++q) {
          const int col = col0 + q;
          float* sp = sc + p * kCols + (col ^ swz(p));
          const float gc = *sp;
          float xv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xv[e] = kBwdSkip & 2 ? wt[e]
                : v[e] ? __ldg(xgp + (size_t)idx[e] * Cg + q) : 0.f;
          }
          dly += gc * (r.hx * (xv[2] - xv[0]) + r.lx * (xv[3] - xv[1]));
          dlx += gc * (r.hy * (xv[1] - xv[0]) + r.ly * (xv[3] - xv[2]));
          if (live) {
            *sp = wt[0] * xv[0] + wt[1] * xv[1] + wt[2] * xv[2] +
                  wt[3] * xv[3];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float val = wt[e] * gc;
            scatter(e, ch.ci0 + col, &val, 1);
            if (tagged && e < 3) __syncwarp();
          }
        }
      }
      if (!live) return;
      if (Cg > kCols) {   // one item a thread: carry the group's sums
        if (ch.cg0 == 0) cy = cx = 0.f;
        cy += dly;
        cx += dlx;
        if (!ch.last) return;
        dly = cy;
        dlx = cx;
      }
      float* dof = a.doff + (((size_t)b * a.G + g) * kTaps + k) * 2 * HW +
                   py * a.W + px;
      dof[0] = dly;
      dof[HW] = dlx;
    };
    if (a.wr) {
      // warp w: group w % ng, the pixel rows from (w / ng) * wrows, a
      // window of its own (the chunk is all C channels: ncb == 1, ng == G)
      const int gl = warp % ch.ng, rb = warp / ch.ng;
      float* wb = win + warp * Cg * wplane;
      int* tg = tags + warp * (a.wr + 1) * (a.wc + 1);
      for (int j = 0; j < a.wrows * kTW / 32; ++j) {
        item(rb * a.wrows * kTW + 32 * j + lane, gl, wb, tg,
             ty0 + rb * a.wrows - a.ey, gl * Cg);
      }
    } else {   // no window: every item's adds go to dx
      for (int it = tid; it < ch.ng * kPix; it += kBwdThreads) {
        item(it % kPix, it / kPix, win, tags, 0, 0);
      }
    }
  };

  // (b) dW of chunk c += gout . S: this warp's 16 x 8 blocks of (Cout,
  // columns), the 128 pixels as K
  auto dweight = [&](int c) {
    if (kBwdSkip & 4) return;
    const float* sc = gs + (c % 3) * kPix * kCols;
    float* dst = dwacc + (size_t)c * a.cout16 * kCols;
    const int njobs = a.cout16 / 16 * 4;
    for (int job = warp; job < njobs; job += kGcolWarp0) {
      const int mt = job >> 2, nt = job & 3;
      // ldmatrix rows: lanes 0-15 rows 0-15 of the block at pixels 0-3 of
      // the k step, lanes 16-31 at pixels 4-7: a0..a3 of the A fragment
      const int lrow = mt * 16 + (lane & 15);
      const int lcol = (lane >> 4) * 4;
      const uint32_t hb = smem_addr(ghi + lrow * kPix);
      const uint32_t lb = smem_addr(glo + lrow * kPix);
      const int sw = gswz(lrow);
      const int ci = nt * 8 + g8;
      // this warp's elements of the partial (device memory where it does
      // not fit shared memory: read before the MMAs, which hide the wait);
      // acc: 0 (o g, column 2t), 1 (g, 2t+1), 2 (g+8, 2t), 3 (g+8, 2t+1);
      // each element has this one owner: no atomics
      const int o = mt * 16 + g8, col = nt * 8 + 2 * t4;
      float2* d0 = reinterpret_cast<float2*>(dst + o * kCols +
                                             (col ^ dswz(o)));
      float2* d1 = reinterpret_cast<float2*>(dst + (o + 8) * kCols +
                                             (col ^ dswz(o)));
      float2 u = *d0, v = *d1;
      // hi.hi and the cross products of even and odd k steps in four
      // chains: one chain of 48 dependent MMAs would wait on each
      float acc[2][4] = {}, accx[2][4] = {};
      auto kstep = [&](int ks, float* ah_acc, float* ax_acc) {
        uint32_t ah[4], al[4];
        const uint32_t at = ((ks * 8 + lcol) ^ sw) * 4;
        ldmatrix_x4(hb + at, ah);
        ldmatrix_x4(lb + at, al);
        // B = S: b0 (pixel t, column g), b1 (pixel t+4, column g)
        const int pk = ks * 8 + t4;
        const float v0 = sc[pk * kCols + (ci ^ swz(pk))];
        const float v1 = sc[(pk + 4) * kCols + (ci ^ swz(pk + 4))];
        const uint32_t bh0 = tf32(v0), bh1 = tf32(v1);
        mma_tf32(ax_acc, al, bh0, bh1);
        mma_tf32(ax_acc, ah, tf32(v0 - __uint_as_float(bh0)),
                 tf32(v1 - __uint_as_float(bh1)));
        mma_tf32(ah_acc, ah, bh0, bh1);
      };
#pragma unroll 2
      for (int ks = 0; ks < kPix / 8; ks += 2) {
        kstep(ks, acc[0], accx[0]);
        kstep(ks + 1, acc[1], accx[1]);
      }
      u.x += (acc[0][0] + acc[1][0]) + (accx[0][0] + accx[1][0]);
      u.y += (acc[0][1] + acc[1][1]) + (accx[0][1] + accx[1][1]);
      v.x += (acc[0][2] + acc[1][2]) + (accx[0][2] + accx[1][2]);
      v.y += (acc[0][3] + acc[1][3]) + (accx[0][3] + accx[1][3]);
      *d0 = u;
      *d1 = v;
    }
  };

  // the windows into dx, and zeroed for the next tile
  auto flush = [&]() {
    if (kBwdSkip & 8) return;
    float* dxb = a.dx + (size_t)b * a.C * HW;
    const int vec = a.vec_dx ? 4 : 1;
    const int nq = a.wc / vec;            // float4s (or floats) a row
    for (int i = tid; i < win_floats / vec; i += kBwdThreads) {
      const int q = i % nq, row = i / nq;   // row of [warps][Cg][wr]
      const int wn = row / a.wr / Cg, cl = row / a.wr - wn * Cg;
      const int ci = wn % a.G * Cg + cl;    // warp wn's group is wn % G
      const int y = ty0 + wn / a.G * a.wrows - a.ey + row % a.wr;
      const int x = tx0 - a.ex + vec * q;
      float* wp = win + row * a.wc + vec * q;
      const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W;
      float* d = dxb + (size_t)ci * HW + y * a.W + x;
      if (a.vec_dx) {   // W % 4 == 0 and x % 4 == 0: all four in or out
        const float4 v = *reinterpret_cast<float4*>(wp);
        *reinterpret_cast<float4*>(wp) = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)) {
          red_add_v4(d, v);
        }
      } else {
        const float v = *wp;
        *wp = 0.f;
        if (in && v != 0.f) atomicAdd(d, v);
      }
    }
  };

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    b = t / tpf;
    const int tt = t - b * tpf;
    ty0 = tt / tiles_w * kTH;
    tx0 = tt % tiles_w * kTW;
    load(0);
    cp_commit();
    if (nc > 1) load(1);
    cp_commit();
    // gout's tile, split: zero past Cout and outside the image
    const float* gb = a.gout + (size_t)b * a.cout * HW;
    for (int i = tid; i < a.cout16 * kPix; i += kBwdThreads) {
      const int o = i / kPix, p = i % kPix;
      const int y = ty0 + p / kTW, x = tx0 + p % kTW;
      const float v = o < a.cout && y < a.H && x < a.W
          ? __ldg(gb + (size_t)o * HW + y * a.W + x) : 0.f;
      const float h = hi_of(v);
      const int at = o * kPix + (p ^ gswz(o));
      ghi[at] = h;
      glo[at] = lo_of(v, h);
    }
    cp_wait<1>();
    // G, chunk 0's offsets and (first tile) the zeroed window and dW
    // partial are in
    __syncthreads();
    if (warp >= kGcolWarp0) gcol(0);
    for (int c = 0; c < nc; ++c) {
      cp_wait<0>();   // chunk c + 1's offsets are in
      // gcol of c, S of c - 1 and c + 1's offsets are visible; the buffers
      // of c - 2 are free
      __syncthreads();
      if (c + 2 < nc) load(c + 2);
      cp_commit();
      if (warp < kGcolWarp0) {
        if (c > 0) dweight(c - 1);
      } else if (c + 1 < nc) {
        gcol(c + 1);
      }
      sample(c);
    }
    __syncthreads();   // the last S and the window are complete
    if (warp < kGcolWarp0) dweight(nc - 1);
    flush();
    __syncthreads();   // G and the buffers are free for the next tile
  }
  if (a.dw_smem) {
    float* pt = a.partial + (size_t)blockIdx.x * per_cta;
    for (int i = tid; i < per_cta; i += kBwdThreads) pt[i] = dwa[i];
  }
}

template <int kCg, int kVec>
int launch_bwd(const BwdArgs& a, int ctas, size_t smem, cudaStream_t stream) {
  static size_t smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem_set[dev] < smem)) {
    err = cudaFuncSetAttribute(deform_bwd_tf32_kernel<kCg, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  deform_bwd_tf32_kernel<kCg, kVec><<<ctas, kBwdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dW[o][ci][k] = sum over the CTAs, in order, of their partials
__global__ void deform_bwd_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dw, int C,
                                         int Cg, int cout, int cout16,
                                         int ncb, int ctas) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cout * C * kTaps) return;
  const int k = i % kTaps, ci = i / kTaps % C, o = i / (kTaps * C);
  int cb, col;
  if (Cg <= kCols) {
    const int gpc = kCols / Cg;
    cb = ci / Cg / gpc;
    col = ci - cb * gpc * Cg;
  } else {
    const int g = ci / Cg, cw = ci - g * Cg;
    cb = g * ((Cg + kCols - 1) / kCols) + cw / kCols;
    col = cw % kCols;
  }
  const size_t per_cta = (size_t)kTaps * ncb * cout16 * kCols;
  const float* p = partial + ((size_t)(k * ncb + cb) * cout16 + o) * kCols +
                   (col ^ dswz(o));
  float s = 0.f;
  for (int t = 0; t < ctas; ++t) s += p[t * per_cta];
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

// The backward's plan (see bwd_plan) for these shapes on `sms` SMs:
// out[0..6] = ctas, ey, ex, wrows, dw_smem, smem bytes, scratch floats.
// Returns cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int romp_deform_conv2d_bwd_plan(int b, int c, int h, int wd,
                                           int g, int cout, int sms,
                                           long long* out) {
  BwdPlan p;
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || g <= 0 || cout <= 0 ||
      sms <= 0 || c % g != 0 || !bwd_plan(b, c, h, wd, g, cout, sms, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long v[7] = {p.ctas, p.ey,   p.ex,     p.wrows,
                          p.dw_smem, (long long)p.smem, p.scratch};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// The backward (see its header above): x (b, c, h, w), off (b, g*2*9, h,
// w), w (cout, c, 3, 3) and gout (b, cout, h, w), f32 and contiguous ->
// dx (b, c, h, w), doff (b, g*2*9, h, w), dw (cout, c, 3, 3), planned
// for `sms` SMs. scratch: 16-byte aligned, of the plan's scratch floats
// (romp_deform_conv2d_bwd_plan). Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int romp_deform_conv2d_bwd_f32(const float* x, const float* off,
                                          const float* w, const float* gout,
                                          float* dx, float* doff, float* dw,
                                          float* scratch, int b, int c,
                                          int h, int wd, int g, int cout,
                                          int pad, int sms,
                                          cudaStream_t stream) {
  BwdPlan p;
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || g <= 0 || cout <= 0 ||
      sms <= 0 || c % g != 0 ||
      (long long)b * h * wd * (c > cout ? c : cout) >= (1ll << 31) ||
      (long long)b * h * wd * g * 2 * kTaps >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      !bwd_plan(b, c, h, wd, g, cout, sms, &p) ||
      (long long)kTaps * p.ncb * p.nko * 128 >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int cg = c / g;
  const int hw = h * wd;
  const int nc = kTaps * p.ncb;
  const int x_total = b * g * hw;
  const int w_total = nc * p.nko * 128;
  float4* wfrag = reinterpret_cast<float4*>(scratch);
  float* xg = scratch + (size_t)w_total * 4;   // stays 16-byte aligned
  float* partial = xg + (size_t)b * c * hw;
  deform_bwd_prep_kernel<<<(x_total + w_total + 255) / 256, 256, 0,
                           stream>>>(x, xg, dx, w, wfrag, hw, cg, x_total, c,
                                     cout, p.ncb, p.nko, w_total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const BwdArgs a{xg,    off,   gout,     wfrag,
                  dx,    doff,  partial,  b,
                  c,     h,     wd,       g,
                  cg,    cout,  pad,      p.ncb,
                  p.nko, p.cout16, p.ngc, p.ey < 0 ? 0 : p.ey,
                  p.ex < 0 ? 0 : p.ex, p.wr, p.wc, p.wrows,
                  p.dw_smem, wd % 4 == 0 ? 1 : 0};
  const bool vec = wd % 4 == 0 && reinterpret_cast<uintptr_t>(off) % 16 == 0;
  const int r = cg == 4
      ? (vec ? launch_bwd<4, 4>(a, p.ctas, p.smem, stream)
             : launch_bwd<4, 1>(a, p.ctas, p.smem, stream))
      : (vec ? launch_bwd<0, 4>(a, p.ctas, p.smem, stream)
             : launch_bwd<0, 1>(a, p.ctas, p.smem, stream));
  if (r != 0) return r;
  const int n = cout * c * kTaps;
  deform_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      partial, dw, c, cg, cout, p.cout16, p.ncb, p.ctas);
  return (int)cudaGetLastError();
}
