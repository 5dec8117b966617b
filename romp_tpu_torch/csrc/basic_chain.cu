// One conv pass of a fused chain of stride-1 HRNet BasicBlocks (inference),
// for Hopper (sm_90a).
//
// Replaces romp_tpu/ops/pallas_fuse.py::fused_basic_chain (_chain_kernel,
// _conv_pass). Each BasicBlock is two passes of this kernel:
//   h = relu(conv3x3(x) * scale1 + shift1)
//   y = relu(conv3x3(h) * scale2 + shift2 + x)
// with the numerics of the TPU kernel: the conv's operands (activations and
// packed weights) are rounded to bf16, products are accumulated in f32, and
// the folded BatchNorm scale/shift, residual and ReLU run in f32.
//
// Why the TPU form does not carry over: the TPU kernel holds a whole padded
// map in VMEM and chains all blocks there. The C=32 branch at 128x128 is
// 2 MB in f32, far over the 227 KB of shared memory a Hopper block can use.
// So this first version makes one launch per conv pass (two per block) and
// keeps the map in device memory between passes.
//
// Design: a block computes a 16 x 16 spatial tile of the output for 32
// output channels. It loops over the input channels in chunks of 16; for
// each chunk it stages the bf16-rounded input tile with its 1-pixel halo
// (zero outside the map: the SAME padding comes from bounds checks) and the
// chunk's 3 x 3 x 16 x 32 weights in shared memory. Each of the 128 threads
// owns two output pixels (rows ly and ly + 8 of the tile) for all 32 output
// channels and accumulates with f32 FMAs on the CUDA cores.
//
// What bounds it: the 9 * C * C FMAs per pixel. This version does them on
// the CUDA cores (f32 FMA), fed from shared memory, at about 8 FMAs per
// 16-byte shared-memory load. Tensor-core MMA (bf16 operands, f32
// accumulators: wgmma or mma.sync) and halo-tiled chaining of a whole
// block in shared memory are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                    // output tile is kTile x kTile
constexpr int kThreads = 128;                // each thread: 2 pixels
constexpr int kRowsPerPass = kThreads / kTile;  // 8
constexpr int kCoT = 32;                     // output channels per block
constexpr int kCiT = 16;                     // input channels per stage
constexpr int kHalo = kTile + 2;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x, residual, out: (B, C, H, W) f32. w: (3C, 3C) bf16 packed as
// w[dy*C + ci, dx*C + co]. scale, shift: (C,) f32. residual may be null.
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_act_kernel(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const float* __restrict__ residual,
                      float* __restrict__ out, int C, int H, int W) {
  __shared__ float xs[kCiT][kHalo][kHalo];
  __shared__ __align__(16) float ws[9][kCiT][kCoT];

  const int tiles_w = (W + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_w) * kTile;
  const int tx0 = (blockIdx.x % tiles_w) * kTile;
  const int co0 = blockIdx.y * kCoT;
  const size_t plane = (size_t)H * W;
  const size_t img = (size_t)blockIdx.z * C * plane;
  const int ly = threadIdx.x / kTile;
  const int lx = threadIdx.x % kTile;
  const int ldw = 3 * C;

  float acc[2][kCoT];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 0; o < kCoT; ++o) acc[r][o] = 0.f;
  }

  for (int ci0 = 0; ci0 < C; ci0 += kCiT) {
    for (int i = threadIdx.x; i < kCiT * kHalo * kHalo; i += kThreads) {
      const int c = i / (kHalo * kHalo);
      const int rem = i - c * (kHalo * kHalo);
      const int yy = rem / kHalo;
      const int xx = rem - yy * kHalo;
      const int gc = ci0 + c;
      const int gy = ty0 + yy - 1;
      const int gx = tx0 + xx - 1;
      float v = 0.f;
      if (gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = bf16_round(x[img + gc * plane + (size_t)gy * W + gx]);
      }
      xs[c][yy][xx] = v;
    }
    for (int i = threadIdx.x; i < 9 * kCiT * kCoT; i += kThreads) {
      const int tap = i / (kCiT * kCoT);
      const int rem = i - tap * (kCiT * kCoT);
      const int c = rem / kCoT;
      const int o = rem - c * kCoT;
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      const int gc = ci0 + c;
      const int go = co0 + o;
      float v = 0.f;
      if (gc < C && go < C) {
        v = __bfloat162float(w[(size_t)(dy * C + gc) * ldw + dx * C + go]);
      }
      ws[tap][c][o] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kCiT; ++c) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3;
        const int dx = tap % 3;
        const float x0 = xs[c][ly + dy][lx + dx];
        const float x1 = xs[c][ly + kRowsPerPass + dy][lx + dx];
        const float4* wr = reinterpret_cast<const float4*>(ws[tap][c]);
#pragma unroll
        for (int q = 0; q < kCoT / 4; ++q) {
          const float4 w4 = wr[q];
          acc[0][4 * q + 0] = fmaf(x0, w4.x, acc[0][4 * q + 0]);
          acc[0][4 * q + 1] = fmaf(x0, w4.y, acc[0][4 * q + 1]);
          acc[0][4 * q + 2] = fmaf(x0, w4.z, acc[0][4 * q + 2]);
          acc[0][4 * q + 3] = fmaf(x0, w4.w, acc[0][4 * q + 3]);
          acc[1][4 * q + 0] = fmaf(x1, w4.x, acc[1][4 * q + 0]);
          acc[1][4 * q + 1] = fmaf(x1, w4.y, acc[1][4 * q + 1]);
          acc[1][4 * q + 2] = fmaf(x1, w4.z, acc[1][4 * q + 2]);
          acc[1][4 * q + 3] = fmaf(x1, w4.w, acc[1][4 * q + 3]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = tx0 + lx;
  if (gx >= W) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gy = ty0 + ly + r * kRowsPerPass;
    if (gy >= H) continue;
#pragma unroll
    for (int o = 0; o < kCoT; ++o) {
      const int go = co0 + o;
      if (go >= C) break;
      const size_t idx = img + go * plane + (size_t)gy * W + gx;
      float v = acc[r][o] * scale[go] + shift[go];
      if (residual != nullptr) v += residual[idx];
      out[idx] = fmaxf(v, 0.f);
    }
  }
}

}  // namespace

// One conv pass: out = relu(conv3x3(bf16(x), bf16(w)) * scale + shift
// [+ residual]). x, residual, out: (batch, c, h, w) f32 contiguous; w the
// (3c, 3c) bf16 packed matrix of one conv. Returns the launch's cudaError_t.
extern "C" int romp_conv3x3_bn_act(const float* x, const void* w,
                                   const float* scale, const float* shift,
                                   const float* residual, float* out,
                                   int batch, int c, int h, int w_dim,
                                   cudaStream_t stream) {
  if (batch <= 0 || c <= 0 || h <= 0 || w_dim <= 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(((h + kTile - 1) / kTile) * ((w_dim + kTile - 1) / kTile),
                  (c + kCoT - 1) / kCoT, batch);
  conv3x3_bn_act_kernel<<<grid, kThreads, 0, stream>>>(
      x, reinterpret_cast<const __nv_bfloat16*>(w), scale, shift, residual,
      out, c, h, w_dim);
  return (int)cudaGetLastError();
}
