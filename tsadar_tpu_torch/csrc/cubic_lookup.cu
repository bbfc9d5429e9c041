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
//
// The table cotangent (cubic_lookup_bwd) replaces
// tsadar_tpu/ops/interp_kernel2.py::cubic_interp_pallas2_bwd: every query
// adds g times its four stencil weights to the entries i0-1 .. i0+2 of its
// row; the tap outside the table in an edge cell has weight 0 and is not
// written.  As for the linear lookup, the TPU version's hi/lo-bf16 one-hot
// contraction and segment fold become one f32 scatter-add into [B, n].
// Bound: q and g in (8 B per query), 1.3 KB per row out: main path ~52 MB,
// ~16 us.  Design: one block per (row, slab of kSlab queries), an n-float
// accumulator in shared memory for each warp (10 KB at n = 320), summed in a
// fixed order and added to the zeroed output with global atomicAdd where
// non-zero.  Real queries crowd: on shot 101675's fit half of them lie beyond
// the velocity grid and clamp onto its end cells (an end entry of a row takes
// ~10^4 deposits), and there the forward overwrites the lookup, so their
// cotangent g is exactly 0; inside the grid the angle-interleaved queries put
// lanes 10 apart into one cell.  So each thread loads kUnroll queries before
// it deposits any, the four taps go through warp_deposit.cuh (runs of
// neighbouring lanes in one cell summed in registers and added once, exact
// zeros not added), and the per-warp accumulators leave only a warp's own
// lanes to contend for an address.  The order of the atomics is not fixed,
// so the last bits may differ from run to run.

#include <cuda_runtime.h>

#include "warp_deposit.cuh"

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

constexpr int kUnroll = 4;
constexpr int kSlab = kThreads * kUnroll * 2;
constexpr int kCopies = kThreads / 32;  // one accumulator per warp

// Each warp deposits into its own n-float accumulator; the block sums the kCopies in a fixed
// order before its global add.  The loop is uniform over the block, so every lane of a warp
// reaches warp_deposit together.
__global__ void cubic_lookup_bwd_kernel(const float* __restrict__ q, const float* __restrict__ g,
                                        const float* __restrict__ meta, float* __restrict__ dtable, int Q, int n) {
  extern __shared__ float acc[];
  const int b = blockIdx.y;
  for (int i = static_cast<int>(threadIdx.x); i < kCopies * n; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  float* warp_acc = acc + (threadIdx.x / 32) * n;

  const float x0 = meta[3 * b + 0];
  const float dx = meta[3 * b + 1];
  const float last = fminf(meta[3 * b + 2], static_cast<float>(n)) - 2.0f;
  const size_t base = static_cast<size_t>(b) * Q;
  const int slab0 = static_cast<int>(blockIdx.x) * kSlab;
  const int end = min(Q, slab0 + kSlab);
  for (int c = slab0; c < end; c += kThreads * kUnroll) {
    float qv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c + u * kThreads + static_cast<int>(threadIdx.x);
      qv[u] = j < end ? q[base + j] : x0;
      gv[u] = j < end ? g[base + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float pos = (qv[u] - x0) / dx;
      const float i0f = fminf(fmaxf(floorf(pos), 0.0f), last);
      const float t = pos - i0f;
      const float t2 = t * t;
      const float t3 = t2 * t;
      const Weights w = stencil(2.0f * t3 - 3.0f * t2 + 1.0f, t3 - 2.0f * t2 + t, -2.0f * t3 + 3.0f * t2,
                                t3 - t2, i0f == 0.0f, i0f == last);
      float v[4] = {gv[u] * w.m1, gv[u] * w.c0, gv[u] * w.p1, gv[u] * w.p2};
      const int key = c + u * kThreads + static_cast<int>(threadIdx.x) < end ? static_cast<int>(i0f) : -1;
      warp_deposit<4, -1>(warp_acc, n, key, v);
    }
  }
  __syncthreads();

  float* row = dtable + static_cast<size_t>(b) * n;
  for (int i = static_cast<int>(threadIdx.x); i < n; i += kThreads) {
    float v = 0.0f;
    for (int w = 0; w < kCopies; ++w) v += acc[w * n + i];
    if (v != 0.0f) atomicAdd(&row[i], v);
  }
}

}  // namespace

// dtable [B, n] must arrive zeroed; n <= 7264 (the kCopies accumulators then fill 227 KB of shared memory).
extern "C" int cubic_lookup_bwd(const void* q, const void* g, const void* meta, void* dtable, int B, int Q, int n,
                                void* stream) {
  const size_t smem = static_cast<size_t>(kCopies) * n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cubic_lookup_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Q + kSlab - 1) / kSlab, B);
  cubic_lookup_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(g), static_cast<const float*>(meta),
      static_cast<float*>(dtable), Q, n);
  return static_cast<int>(cudaGetLastError());
}

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
