// Deformable convolution v1, forward, f32, for Hopper (sm_90a).
//
// Replaces romp_tpu/ops/pallas_deform.py::deform_conv2d_pallas
// (_warp_kernel): 3x3 taps, stride 1, dilation 1, `deform_groups` groups
// each steering C/G input channels, mmcv offset order
// (channel (g*9 + k)*2 + {0: dy, 1: dx}, tap k = ky*3 + kx), bilinear
// sampling with zero outside the image (each corner checked on its own),
// no mask, no bias:
//   out[b, co, p] = sum_{g,k,c} W[co, g*Cg+c, k] * bilinear(x[b, g*Cg+c],
//                                                   p + tap_k + offset_gk(p))
//
// Design (first, simple version): one thread per output pixel, a block for
// a run of 128 pixels of one frame and a tile of up to 32 output channels.
// The block stages its weight tile (9 * C * 32 f32, 36 KB at C = 32) in
// shared memory once; threads read it as broadcasts. Per (group, tap) a
// thread reads its (dy, dx) pair (one coalesced plane each), computes the
// four corners and their weights once, then for each of the group's Cg
// channels gathers the corners (zero weight where a corner is outside),
// blends them and adds the sample times the weight row into 32 register
// accumulators. The TPU kernel accumulated the groups across sequential
// grid steps; here the grid has no order, so the group loop runs inside
// the thread and no atomics are needed. The 32 output planes are written
// coalesced.
//
// What bounds it, at TRACE's shape (B = 8, C = Cout = 32, 128 x 128, G = 8):
// x 16.8 MB + offsets 75.5 MB read once and 16.8 MB written: 33 us at
// 3.35 TB/s; 2.7 GFLOP of f32 FMAs (the 9*C*Cout contraction plus the
// bilinear blend): 40 us at 67 TFLOP/s, so operations bound it. The gathers
// re-read x from L1/L2 (one frame is 2 MB). Tensor cores (the contraction
// is a (pixels x 9C) . (9C x Cout) product after sampling), TMA staging of
// the offsets and tiling are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // pixels per block, one per thread
constexpr int kCoTile = 32;    // output channels per block
constexpr int kTaps = 9;       // 3 x 3
constexpr int kMaxSmem = 232448;

__global__ void __launch_bounds__(kThreads)
deform_conv_kernel(const float* __restrict__ x, const float* __restrict__ off,
                   const float* __restrict__ w, float* __restrict__ out,
                   int C, int H, int W, int G, int cout, int pad) {
  extern __shared__ float4 w_s4[];  // (9 * C, kCoTile) as float4 quads
  float* w_s = reinterpret_cast<float*>(w_s4);
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * kCoTile;
  const int ncol = min(kCoTile, cout - co0);
  // w is (cout, C, 3, 3); w_s[(k * C + ci) * kCoTile + j] = w[co0 + j, ci, k]
  for (int i = threadIdx.x; i < kTaps * C * kCoTile; i += kThreads) {
    const int j = i % kCoTile;
    const int kc = i / kCoTile;
    const int k = kc / C;
    const int ci = kc - k * C;
    w_s[i] = j < ncol ? w[((size_t)(co0 + j) * C + ci) * kTaps + k] : 0.f;
  }
  __syncthreads();

  const int HW = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int py = p / W;
  const int px = p - py * W;
  const int Cg = C / G;
  const float* xb = x + (size_t)b * C * HW;
  const float* ob = off + (size_t)b * G * 2 * kTaps * HW + p;

  float acc[kCoTile];
#pragma unroll
  for (int j = 0; j < kCoTile; ++j) acc[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    for (int k = 0; k < kTaps; ++k) {
      const int ky = k / 3;
      const int kx = k - ky * 3;
      const size_t ch = (size_t)(g * kTaps + k) * 2;
      // clamping far-outside coordinates keeps the int conversion defined
      // and changes nothing: every corner stays outside either way
      const float ys = fminf(fmaxf(py + (ky - pad) + __ldg(ob + ch * HW),
                                   -2.f), (float)H + 1.f);
      const float xs = fminf(fmaxf(px + (kx - pad) + __ldg(ob + (ch + 1) * HW),
                                   -2.f), (float)W + 1.f);
      const float y0f = floorf(ys);
      const float x0f = floorf(xs);
      const float ly = ys - y0f, lx = xs - x0f;
      const float hy = 1.f - ly, hx = 1.f - lx;
      const int y0 = (int)y0f, x0 = (int)x0f;
      const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
      const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const float w00 = (vy0 && vx0) ? hy * hx : 0.f;
      const float w01 = (vy0 && vx1) ? hy * lx : 0.f;
      const float w10 = (vy1 && vx0) ? ly * hx : 0.f;
      const float w11 = (vy1 && vx1) ? ly * lx : 0.f;
      const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y0 + 1, 0), H - 1);
      const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x0 + 1, 0), W - 1);
      const int i00 = yc0 * W + xc0, i01 = yc0 * W + xc1;
      const int i10 = yc1 * W + xc0, i11 = yc1 * W + xc1;
      for (int c = 0; c < Cg; ++c) {
        const int ci = g * Cg + c;
        const float* xc = xb + (size_t)ci * HW;
        const float v = w00 * __ldg(xc + i00) + w01 * __ldg(xc + i01) +
                        w10 * __ldg(xc + i10) + w11 * __ldg(xc + i11);
        const float4* wr = w_s4 + (size_t)(k * C + ci) * (kCoTile / 4);
#pragma unroll
        for (int q = 0; q < kCoTile / 4; ++q) {
          const float4 wv = wr[q];
          acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
        }
      }
    }
  }
  float* outp = out + ((size_t)b * cout + co0) * HW + p;
#pragma unroll
  for (int j = 0; j < kCoTile; ++j) {
    if (j < ncol) outp[(size_t)j * HW] = acc[j];
  }
}

}  // namespace

// x (b, c, h, w), off (b, g*2*9, h, w), w (cout, c, 3, 3) -> out
// (b, cout, h, w), all f32 and contiguous. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int romp_deform_conv2d_f32(const float* x, const float* off,
                                      const float* w, float* out, int b, int c,
                                      int h, int wd, int g, int cout, int pad,
                                      cudaStream_t stream) {
  const size_t smem = (size_t)kTaps * c * kCoTile * sizeof(float);
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || g <= 0 || cout <= 0 ||
      c % g != 0 || b > 65535 || (cout + kCoTile - 1) / kCoTile > 65535 ||
      smem > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deform_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((h * wd + kThreads - 1) / kThreads, b,
                  (cout + kCoTile - 1) / kCoTile);
  deform_conv_kernel<<<grid, kThreads, smem, stream>>>(x, off, w, out, c, h,
                                                       wd, g, cout, pad);
  return (int)cudaGetLastError();
}
