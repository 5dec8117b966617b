// Linear-blend skinning, forward, f32, for Hopper (sm_90a).
//
// Replaces romp_tpu/ops/pallas_lbs.py::skinning_pallas (_skinning_kernel):
//   T16[b] = A16[b] . W^T                          (16 x V per person)
//   verts[b, m, v] = sum_n T16[b, 4m+n, v] * vpos[b, n, v] + T16[b, 4m+3, v]
// As on the TPU, the (N, 16, V) transform block never reaches device memory.
//
// Design: the grid runs over (vertex tiles x person tiles). A block stages
// rows 0-11 of A16 for its persons in shared memory (the apply never reads
// rows 12-15). Each thread owns one vertex, holds W[v, 0:24] in registers
// and, per person, forms the 12 needed dot products over J = 24 and writes
// the (3,) result straight out.
//
// What bounds it: per (person, vertex) it reads 12 bytes of posed vertex,
// writes 12 bytes, and does 12 x 24 FMAs (576 FLOP): about 24 FLOP per byte,
// close to balanced between f32 FMA throughput and HBM bandwidth. W is
// re-read once per person tile and is served from L2. A wgmma/TMA version
// that feeds the 16 x 24 . 24 x V product to the tensor cores is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kJ = 24;         // SMPL joints
constexpr int kRows = 12;      // rows of A16 the apply reads
constexpr int kThreads = 128;  // one vertex per thread
constexpr int kPersons = 8;    // persons per block

__global__ void __launch_bounds__(kThreads)
skinning_kernel(const float* __restrict__ a16, const float* __restrict__ w,
                const float* __restrict__ vpos, float* __restrict__ out,
                int n, int v_count) {
  __shared__ float a_s[kPersons][kRows * kJ];
  const int p0 = blockIdx.y * kPersons;
  const int np = min(kPersons, n - p0);
  for (int i = threadIdx.x; i < np * kRows * kJ; i += kThreads) {
    const int p = i / (kRows * kJ);
    const int r = i - p * (kRows * kJ);
    a_s[p][r] = a16[(size_t)(p0 + p) * 16 * kJ + r];
  }
  __syncthreads();

  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= v_count) return;
  float wv[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) wv[j] = __ldg(w + (size_t)v * kJ + j);

  for (int p = 0; p < np; ++p) {
    float t[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) s = fmaf(a_s[p][k * kJ + j], wv[j], s);
      t[k] = s;
    }
    const size_t base = (size_t)(p0 + p) * 3 * v_count + v;
    const float x = vpos[base];
    const float y = vpos[base + v_count];
    const float z = vpos[base + 2 * (size_t)v_count];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      out[base + m * (size_t)v_count] =
          t[4 * m] * x + t[4 * m + 1] * y + t[4 * m + 2] * z + t[4 * m + 3];
    }
  }
}

}  // namespace

// a16 (n, 16, j), w (v_count, j), vpos (n, 3, v_count) -> out (n, 3, v_count),
// all f32 and contiguous. Returns the cudaError_t of the launch.
extern "C" int romp_skinning_f32(const float* a16, const float* w,
                                 const float* vpos, float* out, int n,
                                 int v_count, int j, cudaStream_t stream) {
  if (j != kJ || n <= 0 || v_count <= 0 || (n + kPersons - 1) / kPersons > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((v_count + kThreads - 1) / kThreads,
                  (n + kPersons - 1) / kPersons);
  skinning_kernel<<<grid, kThreads, 0, stream>>>(a16, w, vpos, out, n, v_count);
  return (int)cudaGetLastError();
}
