// Fused bilinear lookup of the stacked 2V chi tables, and its cotangent.
//
// chi_bilinear_fwd replaces tsadar_tpu/ops/bilinear_kernel.py::chi_bilinear_pallas
// and chi_bilinear_bwd its chi_bilinear_pallas_bwd.  The function: the table
// T [R, C] stacks three column segments, f1d [0, nvx), df1d [nvx, 2 nvx) and
// chi_R [2 nvx, 3 nvx - 2), whose rows live on the periodic angle grid
// 2 pi r / R.  A query (beta, x) interpolates linearly and periodically
// between two rows, then linearly between two columns of each segment, clamped
// at the segment's ends; the first two segments share the velocity grid
// (v0x, dvx), the third has the pole grid (v0p, dvp).  Six outputs per query:
// the three values and their three derivatives in x, which are zero where x
// was clamped.
//
// The TPU version builds a two-hot [R, 512] row-weight matrix per query tile,
// splits it and the tables hi/lo into bf16, contracts them on the matrix unit
// and selects columns by iota compares, because the TPU has no fast gather.
// Here each query gathers its 12 table entries in f32, which is exact; none of
// the split, the tiling or the query padding is carried over.
//
// Bound on this card: memory, and far below a launch's latency.  Forward: per
// query 8 B in and 24 B out, the table (R C 4 B = 391 KB at R = 256, nvx = 128)
// once: Q = 246 784 queries -> 8.3 MB, ~2.5 us at 3.35 TB/s.  Backward: 20 B in
// and 4 B out per query, the table in and its cotangent out: 6.7 MB, ~2 us.
// The arithmetic (~60 operations per query) is two orders below the f32 peak.
//
// Design, forward: one thread per query; queries are read and results written
// coalesced; the 12 gathers go through the read-only cache, where the whole
// table fits in L2 and the rows a warp touches mostly in L1.
//
// Design, backward: one thread per query, which recomputes the cell, reads the
// row difference T[ib1] - T[ib0] at its four columns for dbeta, and deposits
// its 12 contributions to dT [R, C] with atomicAdd into L2.  dT (391 KB) does
// not fit one block's shared memory whole, so there is no block accumulator;
// neighbouring queries of a smooth query field share cells and their atomics
// serialise.  The order of the atomics is not fixed, so the last bits of dT
// vary from run to run.  dxq is not formed here: the caller has the forward's
// derivative outputs and multiplies.
//
// Index math exactly as bilinear_kernel.py:46-67.  Rows: m = beta mod 2 pi with
// the divisor's sign (fmodf keeps the dividend's, so a negative remainder gets
// 2 pi added), bpos = m (R / 2 pi), ib0 = int(floor(bpos)) mod R (bpos can
// round up to R itself: row 0 with weight 0), ib1 = (ib0 + 1) mod R,
// wb = bpos - floor(bpos).  Columns: raw = (x - v0) / dv in true division,
// vpos = clip(raw, 0, ns - 1), iv0 = min(floor(vpos), ns - 2), wv = vpos - iv0,
// inside = 0 < raw < ns - 1, strict on both sides.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;

struct Cell {
  int i0;
  float w;
  float inside;
};

__device__ __forceinline__ void row_cell(float beta, int R, float rows_per_rad, int* ib0, int* ib1, float* wb) {
  float m = fmodf(beta, kTwoPi);
  if (m < 0.0f) m += kTwoPi;
  const float bpos = m * rows_per_rad;
  const float ifl = floorf(bpos);
  *ib0 = static_cast<int>(ifl) % R;
  *ib1 = (*ib0 + 1) % R;
  *wb = bpos - ifl;
}

__device__ __forceinline__ Cell col_cell(float x, float v0, float dv, int ns) {
  const float raw = (x - v0) / dv;
  const float vpos = fminf(fmaxf(raw, 0.0f), static_cast<float>(ns - 1));
  const float i0f = fminf(floorf(vpos), static_cast<float>(ns - 2));
  Cell c;
  c.i0 = static_cast<int>(i0f);
  c.w = vpos - i0f;
  c.inside = (raw > 0.0f && raw < static_cast<float>(ns - 1)) ? 1.0f : 0.0f;
  return c;
}

// value and d/dx of one segment: rows mixed first, then the two columns
__device__ __forceinline__ void segment(const float* __restrict__ r0, const float* __restrict__ r1, float wb, int col,
                                        const Cell& c, float dv, float* val, float* der) {
  const float f0 = (1.0f - wb) * __ldg(r0 + col) + wb * __ldg(r1 + col);
  const float f1 = (1.0f - wb) * __ldg(r0 + col + 1) + wb * __ldg(r1 + col + 1);
  *val = f0 * (1.0f - c.w) + f1 * c.w;
  *der = (f1 - f0) / dv * c.inside;
}

__global__ void chi_bilinear_fwd_kernel(const float* __restrict__ bq, const float* __restrict__ xq,
                                        const float* __restrict__ T, const float* __restrict__ meta,
                                        float* __restrict__ out, int Q, int R, int nvx, float rows_per_rad) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  const float v0x = __ldg(meta), dvx = __ldg(meta + 1), v0p = __ldg(meta + 2), dvp = __ldg(meta + 3);
  const int C = 3 * nvx - 2;
  int ib0, ib1;
  float wb;
  row_cell(bq[q], R, rows_per_rad, &ib0, &ib1, &wb);
  const float* r0 = T + static_cast<size_t>(ib0) * C;
  const float* r1 = T + static_cast<size_t>(ib1) * C;
  const float x = xq[q];
  const Cell cx = col_cell(x, v0x, dvx, nvx);
  const Cell cp = col_cell(x, v0p, dvp, nvx - 2);
  float val, der;
  const size_t sQ = static_cast<size_t>(Q);
  segment(r0, r1, wb, cx.i0, cx, dvx, &val, &der);
  out[q] = val;
  out[3 * sQ + q] = der;
  segment(r0, r1, wb, nvx + cx.i0, cx, dvx, &val, &der);
  out[sQ + q] = val;
  out[4 * sQ + q] = der;
  segment(r0, r1, wb, 2 * nvx + cp.i0, cp, dvp, &val, &der);
  out[2 * sQ + q] = val;
  out[5 * sQ + q] = der;
}

// the four deposits of one segment, and its share of dbeta
__device__ __forceinline__ float deposit(const float* __restrict__ r0, const float* __restrict__ r1,
                                         float* __restrict__ d0, float* __restrict__ d1, float wb, int col,
                                         const Cell& c, float g) {
  const float g0 = g * (1.0f - c.w), g1 = g * c.w;
  atomicAdd(d0 + col, (1.0f - wb) * g0);
  atomicAdd(d0 + col + 1, (1.0f - wb) * g1);
  atomicAdd(d1 + col, wb * g0);
  atomicAdd(d1 + col + 1, wb * g1);
  const float rd = (__ldg(r1 + col) - __ldg(r0 + col)) * (1.0f - c.w) + (__ldg(r1 + col + 1) - __ldg(r0 + col + 1)) * c.w;
  return g * rd;
}

__global__ void chi_bilinear_bwd_kernel(const float* __restrict__ bq, const float* __restrict__ xq,
                                        const float* __restrict__ T, const float* __restrict__ meta,
                                        const float* __restrict__ g, float* __restrict__ dT,
                                        float* __restrict__ dbeta, int Q, int R, int nvx, float rows_per_rad) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  const float v0x = __ldg(meta), dvx = __ldg(meta + 1), v0p = __ldg(meta + 2), dvp = __ldg(meta + 3);
  const int C = 3 * nvx - 2;
  int ib0, ib1;
  float wb;
  row_cell(bq[q], R, rows_per_rad, &ib0, &ib1, &wb);
  const size_t o0 = static_cast<size_t>(ib0) * C, o1 = static_cast<size_t>(ib1) * C;
  const float x = xq[q];
  const Cell cx = col_cell(x, v0x, dvx, nvx);
  const Cell cp = col_cell(x, v0p, dvp, nvx - 2);
  const size_t sQ = static_cast<size_t>(Q);
  float db = deposit(T + o0, T + o1, dT + o0, dT + o1, wb, cx.i0, cx, g[q]);
  db += deposit(T + o0, T + o1, dT + o0, dT + o1, wb, nvx + cx.i0, cx, g[sQ + q]);
  db += deposit(T + o0, T + o1, dT + o0, dT + o1, wb, 2 * nvx + cp.i0, cp, g[2 * sQ + q]);
  dbeta[q] = db * rows_per_rad;
}

}  // namespace

// out [6, Q]: rows (fe, dfe, chiR, d fe/dx, d dfe/dx, d chiR/dx); meta [4] = (v0x, dvx, v0p, dvp) on the device.
extern "C" int chi_bilinear_fwd(const void* bq, const void* xq, const void* T, const void* meta, void* out, int Q,
                                int R, int nvx, float rows_per_rad, void* stream) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  chi_bilinear_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bq), static_cast<const float*>(xq), static_cast<const float*>(T),
      static_cast<const float*>(meta), static_cast<float*>(out), Q, R, nvx, rows_per_rad);
  return static_cast<int>(cudaGetLastError());
}

// g [3, Q]: the cotangents of (fe, dfe, chiR); dT [R, 3 nvx - 2] must arrive zeroed; dbeta [Q].
extern "C" int chi_bilinear_bwd(const void* bq, const void* xq, const void* T, const void* meta, const void* g,
                                void* dT, void* dbeta, int Q, int R, int nvx, float rows_per_rad, void* stream) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  chi_bilinear_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bq), static_cast<const float*>(xq), static_cast<const float*>(T),
      static_cast<const float*>(meta), static_cast<const float*>(g), static_cast<float*>(dT),
      static_cast<float*>(dbeta), Q, R, nvx, rows_per_rad);
  return static_cast<int>(cudaGetLastError());
}
