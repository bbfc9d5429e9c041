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
//
// The table cotangent (lin_lookup_bwd) replaces
// tsadar_tpu/ops/interp_kernel2.py::lin_interp_pallas2_bwd: every query adds
// g (1 - w) to entry i0 and g w to entry i0 + 1 of its row, queries beyond
// the ends included (w is then 0 or 1 onto an end entry).  The TPU version
// builds a hi/lo-bf16 cotangent, contracts it with a transposed one-hot on
// the matrix unit and leaves overlapping segments for the caller to fold;
// here the kernel writes the [B, n] cotangent itself, in f32.
//
// Its bound is memory too: q and g in (8 B per query), the table out (8 KB
// per row): main path ~53 MB, ~16 us.  Design: one block per (row, slab of
// kSlab queries) keeps an n-float accumulator in shared memory, fed by
// shared-memory atomicAdd, and then adds its non-zero entries to the zeroed
// output with global atomicAdd.  Neighbouring queries fall into the same
// cell, so the shared atomics contend; the order of both kinds of atomics is
// not fixed, so the last bits of the sums may differ from run to run.
//
// K10 (lin_lookup_meta_fwd) replaces tsadar_tpu/ops/interp_kernel.py::lin_interp_pallas,
// the JAX package's wrapper interp.interp1d_linear_pallas: K1's function on tables
// zero-padded to a row stride npad >= n + 1, with the grid (x0, dx, n) read from a
// 3-float device tensor, so a launch reads nothing back to the host.  The padding is
// never read (i0 + 1 <= n - 1).  The TPU kernel padded the queries to its 4096-query
// tiles and landed segments with one-hot matmuls; here it is K1's block and cell math,
// one shared device function each, so the two kernels cannot drift apart.  Its table
// cotangent (lin_lookup_meta_bwd, for interp1d_linear_pallas's backward) is K2's body
// reading the same device meta, writing a [B, npad] cotangent (zero past n).  Bounds as
// K1's and K2's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 8;
constexpr int kSlab = kThreads * 32;

// The cell of a query on the grid x0 + dx i, i < n: pos clipped to [0, n-1],
// i0 = min(floor(pos), n-2), w = pos - i0, with true division.
__device__ __forceinline__ int lin_cell(float qv, float x0, float dx, int n, float* w) {
  const float pos = fminf(fmaxf((qv - x0) / dx, 0.0f), static_cast<float>(n - 1));
  const float i0f = fminf(floorf(pos), static_cast<float>(n - 2));
  *w = pos - i0f;
  return static_cast<int>(i0f);
}

// One block's tile of queries of row b: stage the row's n entries, then (value, slope).
__device__ __forceinline__ void lookup_tile(const float* __restrict__ q, const float* __restrict__ row,
                                            float* __restrict__ val, float* __restrict__ slope, float* tab,
                                            int Q, int n, float x0, float dx) {
  for (int i = static_cast<int>(threadIdx.x); i < n; i += kThreads) tab[i] = row[i];
  __syncthreads();

  const size_t base = static_cast<size_t>(blockIdx.y) * Q;
  const int tile0 = static_cast<int>(blockIdx.x) * kTile;
  const int end = min(Q, tile0 + kTile);
  for (int j = tile0 + static_cast<int>(threadIdx.x); j < end; j += kThreads) {
    float w;
    const int i0 = lin_cell(q[base + j], x0, dx, n, &w);
    const float f0 = tab[i0];
    const float f1 = tab[i0 + 1];
    val[base + j] = f0 * (1.0f - w) + f1 * w;
    slope[base + j] = f1 - f0;
  }
}

// One block's slab of queries of row b: deposit into a shared accumulator of `width`
// entries, then add its non-zero entries to the zeroed output row.
__device__ __forceinline__ void deposit_slab(const float* __restrict__ q, const float* __restrict__ g,
                                             float* __restrict__ out_row, float* acc, int Q, int n, int width,
                                             float x0, float dx) {
  for (int i = static_cast<int>(threadIdx.x); i < width; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const size_t base = static_cast<size_t>(blockIdx.y) * Q;
  const int slab0 = static_cast<int>(blockIdx.x) * kSlab;
  const int end = min(Q, slab0 + kSlab);
  for (int j = slab0 + static_cast<int>(threadIdx.x); j < end; j += kThreads) {
    float w;
    const int i0 = lin_cell(q[base + j], x0, dx, n, &w);
    const float gj = g[base + j];
    atomicAdd(&acc[i0], gj * (1.0f - w));
    atomicAdd(&acc[i0 + 1], gj * w);
  }
  __syncthreads();

  for (int i = static_cast<int>(threadIdx.x); i < width; i += kThreads) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&out_row[i], v);
  }
}

// The padded kernels' grid: n from the device meta, kept inside the staged row
// (the caller guarantees 2 <= n <= npad - 1).
__device__ __forceinline__ int meta_n(const float* meta, int npad) {
  return max(2, min(static_cast<int>(meta[2]), npad - 1));
}

__global__ void lin_lookup_kernel(const float* __restrict__ q, const float* __restrict__ table,
                                  float* __restrict__ val, float* __restrict__ slope,
                                  int Q, int n, float x0, float dx) {
  extern __shared__ float tab[];
  lookup_tile(q, table + static_cast<size_t>(blockIdx.y) * n, val, slope, tab, Q, n, x0, dx);
}

__global__ void lin_lookup_meta_kernel(const float* __restrict__ q, const float* __restrict__ table,
                                       const float* __restrict__ meta, float* __restrict__ val,
                                       float* __restrict__ slope, int Q, int npad) {
  extern __shared__ float tab[];
  lookup_tile(q, table + static_cast<size_t>(blockIdx.y) * npad, val, slope, tab, Q, meta_n(meta, npad), meta[0],
              meta[1]);
}

__global__ void lin_lookup_bwd_kernel(const float* __restrict__ q, const float* __restrict__ g,
                                      float* __restrict__ dtable, int Q, int n, float x0, float dx) {
  extern __shared__ float acc[];
  deposit_slab(q, g, dtable + static_cast<size_t>(blockIdx.y) * n, acc, Q, n, n, x0, dx);
}

__global__ void lin_lookup_meta_bwd_kernel(const float* __restrict__ q, const float* __restrict__ g,
                                           const float* __restrict__ meta, float* __restrict__ dtable, int Q,
                                           int npad) {
  extern __shared__ float acc[];
  deposit_slab(q, g, dtable + static_cast<size_t>(blockIdx.y) * npad, acc, Q, meta_n(meta, npad), npad, meta[0],
               meta[1]);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  }
  return 0;
}

}  // namespace

extern "C" int lin_lookup_fwd(const void* q, const void* table, void* val, void* slope,
                              int B, int Q, int n, float x0, float dx, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (int err = set_smem(reinterpret_cast<const void*>(lin_lookup_kernel), smem)) return err;
  const dim3 grid((Q + kTile - 1) / kTile, B);
  lin_lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(table), static_cast<float*>(val),
      static_cast<float*>(slope), Q, n, x0, dx);
  return static_cast<int>(cudaGetLastError());
}

// dtable [B, n] must arrive zeroed.
extern "C" int lin_lookup_bwd(const void* q, const void* g, void* dtable, int B, int Q, int n, float x0, float dx,
                              void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (int err = set_smem(reinterpret_cast<const void*>(lin_lookup_bwd_kernel), smem)) return err;
  const dim3 grid((Q + kSlab - 1) / kSlab, B);
  lin_lookup_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(g), static_cast<float*>(dtable), Q, n, x0, dx);
  return static_cast<int>(cudaGetLastError());
}

// table [B, npad], meta [3] = (x0, dx, n) on the device.
extern "C" int lin_lookup_meta_fwd(const void* q, const void* table, const void* meta, void* val, void* slope,
                                   int B, int Q, int npad, void* stream) {
  const size_t smem = static_cast<size_t>(npad) * sizeof(float);
  if (int err = set_smem(reinterpret_cast<const void*>(lin_lookup_meta_kernel), smem)) return err;
  const dim3 grid((Q + kTile - 1) / kTile, B);
  lin_lookup_meta_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(table), static_cast<const float*>(meta),
      static_cast<float*>(val), static_cast<float*>(slope), Q, npad);
  return static_cast<int>(cudaGetLastError());
}

// dtable [B, npad] must arrive zeroed; entries from n on stay zero.
extern "C" int lin_lookup_meta_bwd(const void* q, const void* g, const void* meta, void* dtable, int B, int Q,
                                   int npad, void* stream) {
  const size_t smem = static_cast<size_t>(npad) * sizeof(float);
  if (int err = set_smem(reinterpret_cast<const void*>(lin_lookup_meta_bwd_kernel), smem)) return err;
  const dim3 grid((Q + kSlab - 1) / kSlab, B);
  lin_lookup_meta_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(g), static_cast<const float*>(meta),
      static_cast<float*>(dtable), Q, npad);
  return static_cast<int>(cudaGetLastError());
}
