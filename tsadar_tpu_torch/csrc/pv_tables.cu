// The chi_R principal-value pole tables of a batch of integrands, and their transpose.
//
// Replaces tsadar_tpu/ops/pv_kernel.py::pv_tables_pallas.  The TPU kernel runs the
// two-stage form (fav/fdif prep, two [M, M] Toeplitz contractions per table on the
// matrix unit, an affine recombination with index weights up to M), which loses
// ~1.6e-4 of the table's max to cancellation in float32.  This kernel computes the
// precombined form table = f @ K (tsadar_tpu/core/physics/ratint.py:184-228), whose
// float32 error is ~2e-7, in one pass for both tables, and writes them interleaved:
// out[b, 2p] = midpoint table at pole p (p < m), out[b, 2p + 1] = node table at pole p
// (p < m - 1; the node table's last pole lies outside the grid and is dropped).
//
// K is Toeplitz but for its first row and its last two: K[j, p] = c[j - p] for
// 0 < j < m, K[0, p] and K[m, p] are rows of their own, K[m + 1] = 0
// (tsadar_tpu_torch/core/physics/ratint.py).  The operand coef [2, 4m] holds, per table,
// c[d] at index d + m - 1 in [0, 2m - 1), row 0 at [2m, 3m) and row m at [3m, 4m): 8m
// floats in shared memory instead of two dense [m + 2, m] matrices.
//
// Bound on this card: operations.  B x (m + 2) x m multiply-adds per table, two tables:
// at the main path's B = 128, m = 1022 that is 0.54 GFLOP, ~8 us at 67 TFLOP/s in float32
// outside the tensor cores (TF32 would keep ~3 digits, too few for these tables); the
// bytes (f, the tables, 33 KB of coefficients: ~1.6 MB) take ~0.5 us.
//
// Design (forward, pv_tables_fwd): one block per (kThreads poles, kRows lineouts).  The
// block stages both tables' coefficients and its rows of f (node-major, kRows floats per
// node, one 16-byte load per node) in shared memory; each thread owns one pole of both
// tables for kRows lineouts and walks the nodes, reading c[j - p] at consecutive
// addresses across the warp (no bank conflicts) and f as a broadcast.  Rows 0 and m of K
// come first, out of the loop.
//
// Transposed mode (pv_tables_bwd): g_f[b, j] = sum_p K_mid[j, p] g[b, 2p]
// + sum_{p < m-1} K_node[j, p] g[b, 2p + 1], the cotangent of the forward, which the TPU
// kernel does not have.  One block per (kThreads nodes, kRows lineouts); the block stages
// its rows of g de-interleaved (pole-major, the node table's dropped pole as 0), and each
// thread owns one node j and walks the poles.  Row j of K is read at c[j - p]: index
// base + step p with (base, step) = (j + m - 1, -1) for an inner row and (2m, 1) or
// (3m, 1) for rows 0 and m, so every thread runs the same loop; row m + 1 is 0.
//
// Both modes accumulate in float32 in a fixed order; no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // one float4 of f (or g) per node (pole) in shared memory
static_assert(kRows == 4, "the loops read kRows lineouts as one float4");

__device__ __forceinline__ void stage_coefficients(const float* __restrict__ coef, float* cs, int m) {
  for (int i = static_cast<int>(threadIdx.x); i < 8 * m; i += kThreads) cs[i] = coef[i];
}

__global__ void pv_tables_fwd_kernel(const float* __restrict__ f, const float* __restrict__ coef,
                                     float* __restrict__ out, int B, int m) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [2][4m]
  float* fs = cs + 8 * m;                       // [m + 2][kRows]
  const int n = m + 2;
  const int b0 = static_cast<int>(blockIdx.y) * kRows;
  stage_coefficients(coef, cs, m);
  for (int i = static_cast<int>(threadIdx.x); i < n * kRows; i += kThreads) {
    const int r = i / n;
    const int j = i - r * n;
    fs[j * kRows + r] = (b0 + r < B) ? f[static_cast<size_t>(b0 + r) * n + j] : 0.0f;
  }
  __syncthreads();

  const int p = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (p >= m) return;
  const float* cmid = cs;
  const float* cnode = cs + 4 * m;
  float am[kRows], an[kRows];
  {
    const float4 f0 = *reinterpret_cast<const float4*>(fs);
    const float4 fm = *reinterpret_cast<const float4*>(fs + m * kRows);
    const float k0m = cmid[2 * m + p], kmm = cmid[3 * m + p];
    const float k0n = cnode[2 * m + p], kmn = cnode[3 * m + p];
    am[0] = f0.x * k0m + fm.x * kmm;
    am[1] = f0.y * k0m + fm.y * kmm;
    am[2] = f0.z * k0m + fm.z * kmm;
    am[3] = f0.w * k0m + fm.w * kmm;
    an[0] = f0.x * k0n + fm.x * kmn;
    an[1] = f0.y * k0n + fm.y * kmn;
    an[2] = f0.z * k0n + fm.z * kmn;
    an[3] = f0.w * k0n + fm.w * kmn;
  }
  const float* km = cmid + (m - 1 - p);  // km[j] = c_mid[j - p]
  const float* kn = cnode + (m - 1 - p);
#pragma unroll 4
  for (int j = 1; j < m; ++j) {
    const float4 fj = *reinterpret_cast<const float4*>(fs + j * kRows);
    const float cm = km[j], cn = kn[j];
    am[0] = fmaf(fj.x, cm, am[0]);
    am[1] = fmaf(fj.y, cm, am[1]);
    am[2] = fmaf(fj.z, cm, am[2]);
    am[3] = fmaf(fj.w, cm, am[3]);
    an[0] = fmaf(fj.x, cn, an[0]);
    an[1] = fmaf(fj.y, cn, an[1]);
    an[2] = fmaf(fj.z, cn, an[2]);
    an[3] = fmaf(fj.w, cn, an[3]);
  }
  const int width = 2 * m - 1;
  for (int r = 0; r < kRows; ++r) {
    if (b0 + r >= B) break;
    float* row = out + static_cast<size_t>(b0 + r) * width;
    row[2 * p] = am[r];
    if (p < m - 1) row[2 * p + 1] = an[r];
  }
}

__global__ void pv_tables_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coef,
                                     float* __restrict__ gf, int B, int m) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [2][4m]
  float* gm = cs + 8 * m;                       // [m][kRows]: cotangent of the midpoint table
  float* gn = gm + m * kRows;                   // [m][kRows]: of the node table, pole m - 1 zero
  const int width = 2 * m - 1;
  const int n = m + 2;
  const int b0 = static_cast<int>(blockIdx.y) * kRows;
  stage_coefficients(coef, cs, m);
  for (int i = static_cast<int>(threadIdx.x); i < width * kRows; i += kThreads) {
    const int r = i / width;
    const int k = i - r * width;
    const float v = (b0 + r < B) ? g[static_cast<size_t>(b0 + r) * width + k] : 0.0f;
    ((k & 1) ? gn : gm)[(k >> 1) * kRows + r] = v;
  }
  for (int r = static_cast<int>(threadIdx.x); r < kRows; r += kThreads) gn[(m - 1) * kRows + r] = 0.0f;
  __syncthreads();

  const int j = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (j >= n) return;
  float acc[kRows] = {};
  if (j <= m) {
    const int base = j == 0 ? 2 * m : (j == m ? 3 * m : j + m - 1);
    const int step = (j == 0 || j == m) ? 1 : -1;
    const float* cmid = cs + base;
    const float* cnode = cs + 4 * m + base;
#pragma unroll 4
    for (int p = 0; p < m; ++p) {
      const float cm = cmid[step * p], cn = cnode[step * p];
      const float4 a = *reinterpret_cast<const float4*>(gm + p * kRows);
      const float4 b = *reinterpret_cast<const float4*>(gn + p * kRows);
      acc[0] = fmaf(a.x, cm, fmaf(b.x, cn, acc[0]));
      acc[1] = fmaf(a.y, cm, fmaf(b.y, cn, acc[1]));
      acc[2] = fmaf(a.z, cm, fmaf(b.z, cn, acc[2]));
      acc[3] = fmaf(a.w, cm, fmaf(b.w, cn, acc[3]));
    }
  }
  for (int r = 0; r < kRows; ++r) {
    if (b0 + r >= B) break;
    gf[static_cast<size_t>(b0 + r) * n + j] = acc[r];
  }
}

int launch_config(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  }
  return 0;
}

}  // namespace

// f [B, m + 2], coef [2, 4m] -> out [B, 2m - 1], interleaved midpoint / node tables.
extern "C" int pv_tables_fwd(const void* f, const void* coef, void* out, int B, int m, void* stream) {
  const size_t smem = static_cast<size_t>(8 * m + (m + 2) * kRows) * sizeof(float);
  if (int err = launch_config(reinterpret_cast<const void*>(pv_tables_fwd_kernel), smem)) return err;
  const dim3 grid((m + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  pv_tables_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(coef), static_cast<float*>(out), B, m);
  return static_cast<int>(cudaGetLastError());
}

// g [B, 2m - 1] (interleaved, as the forward's output), coef [2, 4m] -> gf [B, m + 2].
extern "C" int pv_tables_bwd(const void* g, const void* coef, void* gf, int B, int m, void* stream) {
  const size_t smem = static_cast<size_t>(8 * m + 2 * m * kRows) * sizeof(float);
  if (int err = launch_config(reinterpret_cast<const void*>(pv_tables_bwd_kernel), smem)) return err;
  const dim3 grid((m + 2 + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  pv_tables_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(coef), static_cast<float*>(gf), B, m);
  return static_cast<int>(cudaGetLastError());
}
