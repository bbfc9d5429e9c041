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
// Design, backward: one thread per query recomputes its cell, reads the row
// difference T[ib1] - T[ib0] at its four columns for dbeta, and has 12
// deposits for dT [R, C]: two rows x two columns x three segments, the first
// two segments on one column cell (the velocity grid), the third on its own
// (the pole grid).  dT (391 KB) does not fit one block's shared memory whole,
// so the deposits are atomicAdds into L2.  The deck's queries are its [L, A]
// phase velocities with the 241 fine angles innermost, so the 32 lanes of a
// warp are 32 neighbouring angles at one wavelength: long runs of lanes fall
// into one (row, cell), and thousands of deposits crowd the busiest entry
// (chip_smoke.py reports max_deposits).  So the deposits go through
// warp_deposit.cuh, keyed by (row 0, cell): a run of neighbouring lanes with
// one key is summed by a segmented shuffle scan and added once by its last
// lane, and exact zeros (clamped queries' weights 0 or 1, zero cotangents) are
// not added.  Uniform queries hold no runs and pay a ballot.  The two columns
// of a deposit are neighbours in dT: where the pair is 8-byte aligned (an even
// column: dT's rows have an even length) it goes as one vector atomicAdd
// (float2, sm_90 and later, device memory only), so uniform queries make ~8-9
// atomics a query instead of 12 (14 % faster on them than two scalar ones on
// the H100).  The order of the atomics is not fixed, so the last bits of dT
// vary from run to run.  dxq is not formed here: the caller has the forward's
// derivative outputs and multiplies.
//
// What the first design lost (H100 80GB HBM3, 700 W; chip_smoke.py): one
// atomicAdd per deposit, 12 a query whatever the neighbours, took 0.0557 ms on
// seeded uniform queries and 0.0811 ms on the deck's, 28x and 41x the bound.
//
// Index math exactly as bilinear_kernel.py:46-67.  Rows: m = beta mod 2 pi with
// the divisor's sign (fmodf keeps the dividend's, so a negative remainder gets
// 2 pi added), bpos = m (R / 2 pi), ib0 = int(floor(bpos)) mod R (bpos can
// round up to R itself: row 0 with weight 0), ib1 = (ib0 + 1) mod R,
// wb = bpos - floor(bpos).  Columns: raw = (x - v0) / dv in true division,
// vpos = clip(raw, 0, ns - 1), iv0 = min(floor(vpos), ns - 2), wv = vpos - iv0,
// inside = 0 < raw < ns - 1, strict on both sides.

#include <cstdint>

#include "warp_deposit.cuh"

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

// Adds (a, b) at p and p + 1: one vector atomic where p is 8-byte aligned and neither is an exact zero, else
// each non-zero one on its own.
__device__ __forceinline__ void add_pair(float* p, float a, float b) {
  if (a != 0.0f && b != 0.0f && (reinterpret_cast<uintptr_t>(p) & 7u) == 0) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
  } else {
    add_nonzero(p, a);
    add_nonzero(p + 1, b);
  }
}

// the row difference of one segment at the query's two columns
__device__ __forceinline__ float row_diff(const float* __restrict__ r0, const float* __restrict__ r1, int col,
                                          const Cell& c) {
  return (__ldg(r1 + col) - __ldg(r0 + col)) * (1.0f - c.w) + (__ldg(r1 + col + 1) - __ldg(r0 + col + 1)) * c.w;
}

__global__ void chi_bilinear_bwd_kernel(const float* __restrict__ bq, const float* __restrict__ xq,
                                        const float* __restrict__ T, const float* __restrict__ meta,
                                        const float* __restrict__ g, float* __restrict__ dT,
                                        float* __restrict__ dbeta, int Q, int R, int nvx, float rows_per_rad) {
  // every lane of a warp takes part in its scans: one past the end computes the last query with zero cotangents
  const int q_raw = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = q_raw < Q;
  const int q = valid ? q_raw : Q - 1;
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
  const float gf = valid ? g[q] : 0.0f, gd = valid ? g[sQ + q] : 0.0f, gc = valid ? g[2 * sQ + q] : 0.0f;
  if (valid) {
    const float* r0 = T + o0;
    const float* r1 = T + o1;
    float db = gf * row_diff(r0, r1, cx.i0, cx);
    db += gd * row_diff(r0, r1, nvx + cx.i0, cx);
    db += gc * row_diff(r0, r1, 2 * nvx + cp.i0, cp);
    dbeta[q] = db * rows_per_rad;
  }

  // the first two segments' eight deposits share the key (row 0, velocity cell), the third's four (row 0, pole cell)
  const float w0 = 1.0f - wb;
  const float f0 = gf * (1.0f - cx.w), f1 = gf * cx.w, d0 = gd * (1.0f - cx.w), d1 = gd * cx.w;
  const float p0 = gc * (1.0f - cp.w), p1 = gc * cp.w;
  float vx[8] = {w0 * f0, w0 * f1, w0 * d0, w0 * d1, wb * f0, wb * f1, wb * d0, wb * d1};
  float vp[4] = {w0 * p0, w0 * p1, wb * p0, wb * p1};
  if (warp_runs(valid ? ib0 * C + cx.i0 : -1, vx)) {
    float* t0 = dT + o0 + cx.i0;
    float* t1 = dT + o1 + cx.i0;
    add_pair(t0, vx[0], vx[1]);
    add_pair(t0 + nvx, vx[2], vx[3]);
    add_pair(t1, vx[4], vx[5]);
    add_pair(t1 + nvx, vx[6], vx[7]);
  }
  if (warp_runs(valid ? ib0 * C + 2 * nvx + cp.i0 : -1, vp)) {
    float* t0 = dT + o0 + 2 * nvx + cp.i0;
    float* t1 = dT + o1 + 2 * nvx + cp.i0;
    add_pair(t0, vp[0], vp[1]);
    add_pair(t1, vp[2], vp[3]);
  }
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
