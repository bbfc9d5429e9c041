// Per-row 4-tap cubic Hermite lookup with finite-difference slopes: value and
// d(value)/dt, t the cell coordinate.
//
// Replaces tsadar_tpu/ops/interp_kernel2.py::cubic_interp_pallas2 (the log-EDF
// lookup at the electron phase velocities).  The TPU version landed each
// query's 4-tap stencil through a block one-hot bf16 matmul with a 3-term
// split; here the taps are direct f32 reads from shared memory.
//
// Bound on this card: memory.  Per query q in (4 B), two outputs out (8 B);
// tables add 1.3 KB per row.  Main path: 128 rows x 51 200 queries -> ~79 MB,
// ~24 us at 3.35 TB/s; the Hermite weights (~40 flops/query) stay well below
// the f32 peak.
//
// Design: one block per (row, tile of queries); the row's table (320 floats
// on the main path) and its (x0, dx, n) are staged in shared memory.  Math as
// tsadar_tpu/core/physics/interp.py:_cubic_blocked_indices/_cubic_weights:
// i0 = clip(floor(pos), 0, n-2), t = pos - i0 UNCLAMPED (edge cells
// extrapolate their polynomial), one-sided slope stencils in the first
// (i0 == 0) and last (i0 == n-2) cells.  There the i-1 (first) or i+2 (last)
// tap lies outside the table; its weight is 0 and it is read as 0, never
// loaded (the JAX path pads the table with zeros).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 8;

struct Weights {
  float m1, c0, p1, p2;
};

__device__ __forceinline__ Weights stencil(float h00, float h10, float h01, float h11, bool first, bool last) {
  Weights w;
  if (first) {
    w.m1 = 0.0f;
    w.c0 = h00 - 1.5f * h10 - 0.5f * h11;
    w.p1 = h01 + 2.0f * h10;
    w.p2 = -0.5f * h10 + 0.5f * h11;
  } else if (last) {
    w.m1 = -0.5f * h10 + 0.5f * h11;
    w.c0 = h00 - 2.0f * h11;
    w.p1 = h01 + 0.5f * h10 + 1.5f * h11;
    w.p2 = 0.0f;
  } else {
    w.m1 = -0.5f * h10;
    w.c0 = h00 - 0.5f * h11;
    w.p1 = h01 + 0.5f * h10;
    w.p2 = 0.5f * h11;
  }
  return w;
}

__global__ void cubic_lookup_kernel(const float* __restrict__ q, const float* __restrict__ table,
                                    const float* __restrict__ meta, float* __restrict__ val,
                                    float* __restrict__ dval, int Q, int n) {
  extern __shared__ float tab[];
  const int b = blockIdx.y;
  const float* row = table + static_cast<size_t>(b) * n;
  for (int i = static_cast<int>(threadIdx.x); i < n; i += kThreads) tab[i] = row[i];
  __syncthreads();

  const float x0 = meta[3 * b + 0];
  const float dx = meta[3 * b + 1];
  // meta's n is the grid size; never let it point past the table's own length
  const float last = fminf(meta[3 * b + 2], static_cast<float>(n)) - 2.0f;
  const size_t base = static_cast<size_t>(b) * Q;
  const int tile0 = static_cast<int>(blockIdx.x) * kTile;
  const int end = min(Q, tile0 + kTile);
  for (int j = tile0 + static_cast<int>(threadIdx.x); j < end; j += kThreads) {
    const float pos = (q[base + j] - x0) / dx;
    const float i0f = fminf(fmaxf(floorf(pos), 0.0f), last);
    const float t = pos - i0f;
    const int i0 = static_cast<int>(i0f);
    const bool first = i0f == 0.0f;
    const bool is_last = i0f == last;
    const float fm1 = i0 >= 1 ? tab[i0 - 1] : 0.0f;
    const float f0 = tab[i0];
    const float f1 = tab[i0 + 1];
    const float f2 = i0 + 2 < n ? tab[i0 + 2] : 0.0f;

    const float t2 = t * t;
    const float t3 = t2 * t;
    const Weights c = stencil(2.0f * t3 - 3.0f * t2 + 1.0f, t3 - 2.0f * t2 + t, -2.0f * t3 + 3.0f * t2,
                              t3 - t2, first, is_last);
    const Weights d = stencil(6.0f * t2 - 6.0f * t, 3.0f * t2 - 4.0f * t + 1.0f, 6.0f * t - 6.0f * t2,
                              3.0f * t2 - 2.0f * t, first, is_last);
    val[base + j] = c.m1 * fm1 + c.c0 * f0 + c.p1 * f1 + c.p2 * f2;
    dval[base + j] = d.m1 * fm1 + d.c0 * f0 + d.p1 * f1 + d.p2 * f2;
  }
}

}  // namespace

extern "C" int cubic_lookup_fwd(const void* q, const void* table, const void* meta, void* val, void* dval,
                                int B, int Q, int n, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cubic_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Q + kTile - 1) / kTile, B);
  cubic_lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(table), static_cast<const float*>(meta),
      static_cast<float*>(val), static_cast<float*>(dval), Q, n);
  return static_cast<int>(cudaGetLastError());
}
