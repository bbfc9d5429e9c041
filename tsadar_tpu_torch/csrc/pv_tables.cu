// The chi_R principal-value pole tables of a batch of integrands, and their transpose.
//
// Replaces tsadar_tpu/ops/pv_kernel.py::pv_tables_pallas.  The TPU kernel runs the
// two-stage form (fav/fdif prep, two [M, M] Toeplitz contractions per table on the
// matrix unit, an affine recombination with index weights up to M), which loses
// ~1.6e-4 of the table's max to cancellation in float32.  This kernel computes the
// precombined form table = f @ K (tsadar_tpu/core/physics/ratint.py:184-228) for both
// tables in one pass, and writes them interleaved: out[b, 2p] = midpoint table at pole
// p (p < m), out[b, 2p + 1] = node table at pole p (p < m - 1; the node table's last
// pole lies outside the grid).  Transposed mode (pv_tables_bwd, which the TPU kernel
// does not have): g_f[b, j] = sum_p K_mid[j, p] g[b, 2p] + sum_{p < m-1} K_node[j, p] g[b, 2p + 1].
//
// K is Toeplitz but for its first row and its last two: K[j, p] = c[j - p] for
// 0 < j < m, K[0, p] and K[m, p] are rows of their own, K[m + 1] = 0
// (tsadar_tpu_torch/core/physics/ratint.py).  The operand coef [2, 4m] holds, per table,
// c[d] at index d + m - 1 in [0, 2m - 1), row 0 at [2m, 3m) and row m at [3m, 4m).
//
// Bound on this card: operations.  B x (m + 2) x m multiply-adds per table, two tables:
// at the main path's B = 128, m = 1022 that is 0.54 GFLOP, ~8 us at 67 TFLOP/s in float32
// outside the tensor cores; the bytes (f, the tables, 33 KB of coefficients: ~1.6 MB)
// take ~0.5 us.  TF32 alone would keep ~3 digits, too few for these tables; three TF32
// products a term (below) are 1.6 GFLOP, ~3.3 us at the dense TF32 rate (495 TFLOP/s):
// that is this design's own bound.
//
// What the first design lost (H100 80GB HBM3, 700 W): 0.0306 ms forward and 0.0477 ms
// transposed, 3.8x and 6.0x the float32 bound, slower than one torch.matmul with the two
// dense matrices side by side (0.0239 / 0.0252 ms).  It ran one thread per (pole, 4
// lineouts), 256 blocks of 128 threads over 132 SMs (~8 warps an SM), each thread a
// 1021-step dependent loop with 3 (transposed: 4) shared-memory reads per 8 multiply-adds.
// A register-blocked float32 form (4 poles x 8 lineouts a thread over a sliding window,
// the contraction split over a cluster) measured no faster than that forward: the float32
// rate of the SMs, not latency, bounds that form.
//
// This design: the tensor cores at float32 accuracy (3xTF32), the contraction split over
// blocks that each write a share, and a second small kernel that sums the shares.
// * Each operand x is split into TF32 parts, x = hi + lo (cvt.rna), and a product is
//   a_lo b_hi + a_hi b_lo + a_hi b_hi (lo lo, 2^-22 of it, is dropped), each term an
//   mma.sync.m16n8k8 with float32 sums.
// * A block owns a tile of kOut outputs (poles; nodes in the transposed mode) x kRows
//   lineouts; warp w owns outputs [32 w, 32 w + 32) x the 32 lineouts: 2 x 4 mma tiles
//   (per table in the forward).  The A operand is the staged integrand (or cotangent)
//   [index][lineout]; the B operand is never built as a matrix: K[j][p] of the tile is the
//   Toeplitz window cw[u], u = kl - pl + kOut - 1, so a lane reads its B fragment
//   (k = tig, tig + 4; n = gid) straight from the window, split once into TF32 parts when
//   it is staged.  Per 8 contraction steps a warp loads all its fragments, then issues its
//   48 mma in three passes (lo-hi, hi-lo, hi-hi) so that no mma waits on the one before.
// * The block stages, per segment of kChunk contraction indices, the operand (transposed,
//   rows padded to 40 floats so that a fragment's 32 lanes hit 32 banks) and the window of
//   kChunk + kOut - 1 coefficients per table, read from coef by one index rule; outside
//   the interior range it stages 0.  All of it arrives by asynchronous copies (cp.async,
//   one wait a segment).  The special rows 0, m, m + 1 stage a zero operand (forward), or
//   overwrite their outputs (transposed), and are added from rows 0 and m of coef,
//   staged beside.
// * kSplit blocks share the contraction: block q takes segments q, q + kSplit, ...  With
//   B = 128, m = 1022 that is 8 x 4 x 8 = 256 blocks of 4 warps.  Each writes its partial
//   tile to its own share, [kSplit][B][width] in the output's allocation right after the
//   output; the second kernel adds the shares in order q = 0, 1, ...  The order of every
//   sum is fixed: results do not change from run to run.  No atomics.  (A cluster's
//   distributed shared memory in place of the shares measured slower in both modes.)
//
// The index rule (staging, window, fragments, segments, special rows, the ordered sum of the
// shares) is modelled in float64 by tests/test_torch_pv_tables.py against ratint.pv_tables_matmul.

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOut = 128;        // outputs of a block's tile: 4 warps x 32
constexpr int kRows = 32;        // lineouts of a block's tile: 2 mma tiles of 16
constexpr int kChunk = 128;      // contraction indices staged at a time
constexpr int kSplit = 8;        // blocks that share the contraction, each writing its own share
constexpr int kRowStride = kRows + 8;         // staged operand row, padded: a fragment's lanes hit 32 banks
constexpr int kWindow = kChunk + kOut - 1;    // coefficients a segment reads, per table
static_assert(kThreads == 128 && kOut == 4 * 32 && kRows == 32, "warp w owns outputs [32 w, 32 w + 32) x all 32 lineouts");
static_assert(kChunk % 8 == 0, "");
// dynamic shared memory, in floats: the forward's operand / partial tile, windows and edge rows; the
// transposed mode's two operands (then its partial tile), windows and edge rows
constexpr int kFwdPart = kRows * 2 * kOut;
static_assert(kChunk * kRowStride <= kFwdPart && kRows * kOut <= 2 * kChunk * kRowStride, "");
constexpr int kWin = kWindow + 1;
constexpr int kFwdSmem = kFwdPart + 4 * kWin + 2 * kRows + 4 * kOut;
constexpr int kBwdSmem = 2 * kChunk * kRowStride + 4 * kWin + 4 * kChunk;

// cw[u] = c[idx0 + sign u], u in [0, kWindow), and 0 outside c's interior range [0, 2m - 1).
__device__ __forceinline__ void stage_window(const float* __restrict__ c, float* cw, int idx0, int sign, int m) {
  for (int u = static_cast<int>(threadIdx.x); u < kWindow; u += kThreads) {
    const int i = idx0 + sign * u;
    copy_async(cw + u, c + i, i >= 0 && i < 2 * m - 1);
  }
}

// x = hi + lo, both TF32 (round to nearest, ties away).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a b on a 16 x 8 tile, k = 8: TF32 operands, float32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The staged windows cw_hi [2][kWin] split in place: cw_hi keeps the TF32 high parts, cw_lo gets the low.
__device__ __forceinline__ void split_windows(float* cw_hi, float* cw_lo) {
  for (int u = static_cast<int>(threadIdx.x); u < 2 * kWin; u += kThreads) {
    unsigned hi, lo;
    split(cw_hi[u], hi, lo);
    cw_hi[u] = __uint_as_float(hi);
    cw_lo[u] = __uint_as_float(lo);
  }
}

// Lane (gid, tig) of the A fragment (16 lineouts from `row` x 8 indices from kl) of xs [index][lineout]:
// (row + gid, kl + tig), (row + gid + 8, kl + tig), (row + gid, kl + tig + 4), (row + gid + 8, kl + tig + 4).
__device__ __forceinline__ void a_frag(const float* xs, int kl, int row, int gid, int tig, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  const float* p = xs + (kl + tig) * kRowStride + row + gid;
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * kRowStride], hi[2], lo[2]);
  split(p[4 * kRowStride + 8], hi[3], lo[3]);
}

// Lane (gid, tig) of the B fragment (8 indices from kl x 8 outputs from pl): K at (kl + tig, pl + gid)
// and (kl + tig + 4, pl + gid), i.e. cw[kl - pl + kOut - 1 + tig - gid] and 4 further, already split.
__device__ __forceinline__ void b_frag(const float* cw_hi, const float* cw_lo, int kl, int pl, int gid, int tig,
                                       unsigned (&hi)[2], unsigned (&lo)[2]) {
  const int u = kl - pl + kOut - 1 + tig - gid;
  hi[0] = __float_as_uint(cw_hi[u]);
  hi[1] = __float_as_uint(cw_hi[u + 4]);
  lo[0] = __float_as_uint(cw_lo[u]);
  lo[1] = __float_as_uint(cw_lo[u + 4]);
}

// Forward: block (q, pole tile, lineout tile) writes its share of out [B, 2m - 1] from f [B, n = m + 2]
// to shares[q].  Grid (kSplit, poles / kOut, B / kRows).
__global__ void __launch_bounds__(kThreads)
    pv_tables_fwd_kernel(const float* __restrict__ f, const float* __restrict__ coef, float* __restrict__ shares, int B,
                         int m) {
  extern __shared__ __align__(16) float smem[];
  float* xs_part = smem;                                     // operand [kChunk][kRowStride], then the partial tile
  float(*cw)[kWin] = reinterpret_cast<float(*)[kWin]>(smem + kFwdPart);                 // [2]: the windows' high parts
  float(*cw_lo)[kWin] = reinterpret_cast<float(*)[kWin]>(smem + kFwdPart + 2 * kWin);  // [2]: their low parts
  float(*edge_f)[kRows] = reinterpret_cast<float(*)[kRows]>(smem + kFwdPart + 4 * kWin);  // f at nodes 0 and m
  float(*edge_k)[kOut] = reinterpret_cast<float(*)[kOut]>(smem + kFwdPart + 4 * kWin + 2 * kRows);  // rows 0, m of K_mid, K_node
  const int n = m + 2;
  const int rank = static_cast<int>(blockIdx.x);
  const int o0 = static_cast<int>(blockIdx.y) * kOut;
  const int b0 = static_cast<int>(blockIdx.z) * kRows;
  const int tid = static_cast<int>(threadIdx.x);
  const int gid = (tid & 31) >> 2, tig = tid & 3, wp = (tid >> 5) * 32;

  // rows 0 and m of K, in the blocks whose segments hold nodes 0 and m
  const bool has0 = rank == 0, hasm = (m / kChunk) % kSplit == rank;
  if (has0 || hasm) {
    for (int i = tid; i < 2 * kRows; i += kThreads) {
      const int b = b0 + (i % kRows), j = i < kRows ? 0 : m;
      copy_async(&edge_f[i / kRows][i % kRows], f + static_cast<size_t>(b) * n + j, b < B);
    }
    for (int i = tid; i < 4 * kOut; i += kThreads) {
      const int row = i / kOut, p = o0 + i % kOut;
      copy_async(&edge_k[row][i % kOut], coef + (row >> 1) * 4 * m + ((row & 1) ? 3 * m : 2 * m) + p, p < m);
    }
  }

  float acc[2][2][4][4] = {};  // [table][lineout tile][pole tile][fragment]
  for (int k0 = rank * kChunk; k0 < n; k0 += kSplit * kChunk) {
    __syncthreads();  // the previous segment is consumed
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, kl = i - r * kChunk;
      const int j = k0 + kl;  // node; rows 0, m, m + 1 of K are not Toeplitz: staged as 0, added below
      copy_async(xs_part + kl * kRowStride + r, f + static_cast<size_t>(b0 + r) * n + j, b0 + r < B && j >= 1 && j < m);
    }
    for (int t = 0; t < 2; ++t) stage_window(coef + t * 4 * m, cw[t], k0 - o0 - (kOut - 1) + m - 1, 1, m);
    copies_done();
    __syncthreads();
    split_windows(cw[0], cw_lo[0]);
    __syncthreads();
#pragma unroll 2
    for (int kl = 0; kl < kChunk; kl += 8) {
      unsigned ah[2][4], al[2][4], bh[2][4][2], bl[2][4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) a_frag(xs_part, kl, 16 * mt, gid, tig, ah[mt], al[mt]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) b_frag(cw[t], cw_lo[t], kl, wp + 8 * nt, gid, tig, bh[t][nt], bl[t][nt]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[t][mt][nt], al[mt], bh[t][nt]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[t][mt][nt], ah[mt], bl[t][nt]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[t][mt][nt], ah[mt], bh[t][nt]);
    }
  }

  // fragment element i of tile (mt, nt): lineout 16 mt + gid + 8 (i >> 1), pole wp + 8 nt + 2 tig + (i & 1)
  if (has0 || hasm) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * mt + gid + 8 * (i >> 1), pl = wp + 8 * nt + 2 * tig + (i & 1);
            if (has0) acc[t][mt][nt][i] = fmaf(edge_f[0][r], edge_k[2 * t][pl], acc[t][mt][nt][i]);
            if (hasm) acc[t][mt][nt][i] = fmaf(edge_f[1][r], edge_k[2 * t + 1][pl], acc[t][mt][nt][i]);
          }
  }

  // the partial tile [kRows][2 kOut], interleaved as the output row
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + gid + 8 * (i >> 1), pl = wp + 8 * nt + 2 * tig + (i & 1);
        *reinterpret_cast<float2*>(xs_part + r * (2 * kOut) + 2 * pl) = make_float2(acc[0][mt][nt][i], acc[1][mt][nt][i]);
      }
  __syncthreads();
  const int width = 2 * m - 1;
  float* share = shares + static_cast<size_t>(rank) * B * width;
  for (int i = tid; i < kRows * 2 * kOut; i += kThreads) {
    const int b = b0 + i / (2 * kOut), k = 2 * o0 + i % (2 * kOut);
    if (b < B && k < width) share[static_cast<size_t>(b) * width + k] = xs_part[i];
  }
}

// Transposed: block (q, node tile, lineout tile) writes its share of gf [B, n = m + 2] from g [B, 2m - 1]
// to shares[q].  Grid (kSplit, nodes / kOut, B / kRows).
__global__ void __launch_bounds__(kThreads)
    pv_tables_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coef, float* __restrict__ shares, int B,
                         int m) {
  extern __shared__ __align__(16) float smem[];
  float* xs_part = smem;  // g_mid, g_node [kChunk][kRowStride]; then the partial tile
  float(*cw)[kWin] = reinterpret_cast<float(*)[kWin]>(smem + 2 * kChunk * kRowStride);               // [2]
  float(*cw_lo)[kWin] = reinterpret_cast<float(*)[kWin]>(smem + 2 * kChunk * kRowStride + 2 * kWin);  // [2]
  // rows 0 and m of K_mid, K_node at the segment's poles: [2 sel + table]
  float(*edge_k)[kChunk] = reinterpret_cast<float(*)[kChunk]>(smem + 2 * kChunk * kRowStride + 4 * kWin);
  float* const xs[2] = {xs_part, xs_part + kChunk * kRowStride};
  const int n = m + 2, width = 2 * m - 1;
  const int rank = static_cast<int>(blockIdx.x);
  const int o0 = static_cast<int>(blockIdx.y) * kOut;
  const int b0 = static_cast<int>(blockIdx.z) * kRows;
  const int tid = static_cast<int>(threadIdx.x);
  const int gid = (tid & 31) >> 2, tig = tid & 3, wp = (tid >> 5) * 32;

  // rows 0 and m of K are not Toeplitz: threads (node, lineout, table) = (t / 64, t / 2 % 32, t % 2)
  // sum them on their own when the node lies in this tile
  const bool edges = o0 == 0 || (m >= o0 && m < o0 + kOut);
  const int sp_sel = tid >> 6, sp_row = (tid >> 1) & 31, sp_tab = tid & 1;
  const int sp_node = sp_sel ? m : 0;
  const bool sp_here = sp_node >= o0 && sp_node < o0 + kOut;
  float sp[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  float acc[2][4][4] = {};  // [lineout tile][node tile][fragment]
  for (int k0 = rank * kChunk; k0 < m; k0 += kSplit * kChunk) {
    __syncthreads();
    for (int i = tid; i < kRows * 2 * kChunk; i += kThreads) {
      const int r = i / (2 * kChunk), e = i - r * (2 * kChunk);
      const int k = 2 * k0 + e;  // interleaved entry: pole k / 2 of table k % 2; the node table's pole m - 1 is 0
      copy_async(((e & 1) ? xs[1] : xs[0]) + (e >> 1) * kRowStride + r, g + static_cast<size_t>(b0 + r) * width + k, b0 + r < B && k < width);
    }
    for (int t = 0; t < 2; ++t) stage_window(coef + t * 4 * m, cw[t], o0 - k0 + kOut + m - 2, -1, m);
    if (edges) {
      for (int i = tid; i < 4 * kChunk; i += kThreads) {
        const int row = i / kChunk, p = k0 + i % kChunk;
        copy_async(&edge_k[row][i % kChunk], coef + (row & 1) * 4 * m + ((row >> 1) ? 3 * m : 2 * m) + p, p < m);
      }
    }
    copies_done();
    __syncthreads();
    split_windows(cw[0], cw_lo[0]);
    __syncthreads();
#pragma unroll 2
    for (int kl = 0; kl < kChunk; kl += 8) {
      unsigned ah[2][2][4], al[2][2][4], bh[2][4][2], bl[2][4][2];  // [table][tile][...]
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) a_frag(xs[t], kl, 16 * mt, gid, tig, ah[t][mt], al[t][mt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) b_frag(cw[t], cw_lo[t], kl, wp + 8 * nt, gid, tig, bh[t][nt], bl[t][nt]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], al[t][mt], bh[t][nt]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], ah[t][mt], bl[t][nt]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], ah[t][mt], bh[t][nt]);
    }
    if (sp_here) {
      const float* x = (sp_tab ? xs[1] : xs[0]) + sp_row;
      const float* k = edge_k[2 * sp_sel + sp_tab];
#pragma unroll 8
      for (int kl = 0; kl < kChunk; ++kl) sp[kl & 3] = fmaf(k[kl], x[kl * kRowStride], sp[kl & 3]);
    }
  }

  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(xs_part + (16 * mt + gid + 8 * h) * kOut + wp + 8 * nt + 2 * tig) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  const float sp_sum = (sp[0] + sp[1]) + (sp[2] + sp[3]);
  const float sp_other = __shfl_xor_sync(0xffffffffu, sp_sum, 1);  // the other table's share
  __syncthreads();
  if (sp_here && sp_tab == 0) xs_part[sp_row * kOut + (sp_node - o0)] = sp_sum + sp_other;
  if (m + 1 >= o0 && m + 1 < o0 + kOut && tid < kRows) xs_part[tid * kOut + (m + 1 - o0)] = 0.0f;
  __syncthreads();
  float* share = shares + static_cast<size_t>(rank) * B * n;
  for (int i = tid; i < kRows * kOut; i += kThreads) {
    const int b = b0 + i / kOut, j = o0 + i % kOut;
    if (b < B && j < n) share[static_cast<size_t>(b) * n + j] = xs_part[i];
  }
}

// y[i] = shares[0][i] + shares[1][i] + ... + shares[kSplit - 1][i], in that order.
__global__ void sum_shares(const float* __restrict__ shares, float* __restrict__ y, int total) {
  const int i = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= total) return;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kSplit; ++q) s += shares[static_cast<size_t>(q) * total + i];
  y[i] = s;
}

dim3 grid_of(int outputs, int B) { return dim3(kSplit, (outputs + kOut - 1) / kOut, (B + kRows - 1) / kRows); }

// The shares follow y [B, width] in its allocation: [kSplit][B][width].  The first kernel writes them,
// the second sums them into y.
template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const void* x, const void* coef, void* y, int B, int m, int width,
           void* stream) {
  if (const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))
    return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = B * width;
  float* shares = static_cast<float*>(y) + total;
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const float*>(x), static_cast<const float*>(coef), shares, B, m);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  sum_shares<<<(total + 255) / 256, 256, 0, st>>>(shares, static_cast<float*>(y), total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f [B, m + 2], coef [2, 4m] -> out [B, 2m - 1], interleaved midpoint / node tables; out's allocation
// holds kSplit further [B, 2m - 1] after it for the shares.
extern "C" int pv_tables_fwd(const void* f, const void* coef, void* out, int B, int m, void* stream) {
  return launch(pv_tables_fwd_kernel, kFwdSmem * sizeof(float), grid_of(m, B), f, coef, out, B, m, 2 * m - 1, stream);
}

// g [B, 2m - 1] (interleaved, as the forward's output), coef [2, 4m] -> gf [B, m + 2]; gf's allocation
// holds kSplit further [B, m + 2] after it for the shares.
extern "C" int pv_tables_bwd(const void* g, const void* coef, void* gf, int B, int m, void* stream) {
  return launch(pv_tables_bwd_kernel, kBwdSmem * sizeof(float), grid_of(m + 2, B), g, coef, gf, B, m, m + 2, stream);
}
