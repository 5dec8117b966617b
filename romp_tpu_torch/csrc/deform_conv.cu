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
