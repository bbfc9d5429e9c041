// Per-row linear lookup on a uniform grid: value and slope f[i0+1] - f[i0].
//
// Replaces tsadar_tpu/ops/interp_kernel2.py::lin_interp_pallas2 (the chi_R
// pole-table lookup at the electron phase velocities).  The TPU version landed
// each query's table segment with one-hot bf16 matmuls and a 3-term hi/lo
// split because the TPU has no fast gather; on Hopper a direct f32 gather from
// shared memory is exact, so none of that is carried over.
//
// Bound on this card: memory.  Per query it reads q (4 B) and writes two
// outputs (8 B); the tables add 8 KB per row.  Main path: 128 rows x 51 200
// queries -> ~79 MB, ~24 us at 3.35 TB/s; the arithmetic (~10 flops/query) is
// far below the f32 peak.
//
// Design: one block per (row, tile of TILE queries).  The block stages its
// row's table (2043 floats = 8 KB on the main path) in shared memory once and
// every thread then walks the tile with coalesced loads and stores, so device
// memory sees each query byte once and each table once per tile.
//
// Index math exactly as interp_kernel2.py:46-52: pos clipped to [0, n-1],
// i0 = min(floor(pos), n-2), w = pos - i0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 8;

__global__ void lin_lookup_kernel(const float* __restrict__ q, const float* __restrict__ table,
                                  float* __restrict__ val, float* __restrict__ slope,
                                  int Q, int n, float x0, float dx) {
  extern __shared__ float tab[];
  const int b = blockIdx.y;
  const float* row = table + static_cast<size_t>(b) * n;
  for (int i = static_cast<int>(threadIdx.x); i < n; i += kThreads) tab[i] = row[i];
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * Q;
  const float top = static_cast<float>(n - 1);
  const float last = static_cast<float>(n - 2);
  const int tile0 = static_cast<int>(blockIdx.x) * kTile;
  const int end = min(Q, tile0 + kTile);
  for (int j = tile0 + static_cast<int>(threadIdx.x); j < end; j += kThreads) {
    const float pos = fminf(fmaxf((q[base + j] - x0) / dx, 0.0f), top);
    const float i0f = fminf(floorf(pos), last);
    const float w = pos - i0f;
    const int i0 = static_cast<int>(i0f);
    const float f0 = tab[i0];
    const float f1 = tab[i0 + 1];
    val[base + j] = f0 * (1.0f - w) + f1 * w;
    slope[base + j] = f1 - f0;
  }
}

}  // namespace

extern "C" int lin_lookup_fwd(const void* q, const void* table, void* val, void* slope,
                              int B, int Q, int n, float x0, float dx, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(lin_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Q + kTile - 1) / kTile, B);
  lin_lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(table), static_cast<float*>(val),
      static_cast<float*>(slope), Q, n, x0, dx);
  return static_cast<int>(cudaGetLastError());
}
