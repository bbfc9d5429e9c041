// Every cotangent of the 1V spectrum tail in one pass: g_lf and g_chi
// [B, G, L, A], g_ne and g_Te [B, G], g_lam, g_Va and g_ud [B], and g_Z,
// g_Ti and g_fract [B, S], from the cotangent g [B, L] of the reduced
// spectrum and the forward's own inputs.
//
// Replaces tsadar_tpu/ops/spectrum_kernel.py::spectrum_tail_pallas_bwd (the
// row form of tsadar_tpu/core/physics/form_factor.py::_rt_bwd).  The plain
// twin is torch.autograd of form_factor._reduced_tail
// (tsadar_tpu_torch/ops/spectrum_tail.py::plain_bwd).  A, the angle weights,
// the angles and the frequency axis are constants and get no cotangent.
//
// Bound on this card: it reads lf and chi once (8 B per point) and writes
// g_lf and g_chi (8 B per point), plus g and the per-lineout scalars: main
// path [128, 1, 5120, 10] -> ~108 MB, ~32 us at 3.35 TB/s.  The arithmetic is
// the forward's (recomputed, nothing but its inputs is saved) plus about as
// much again for the chain rule: counted as operations (each transcendental
// and each division as one) it is ~45 us at 67 TFLOP/s.  What it really waits
// on is instruction issue: an IEEE float32 division or square root is a
// sequence of ~8-10 instructions, expf ~6-8, and every point runs ~450 other
// operations (PERF.md gives the issue estimate from the SASS).
//
// What the first design lost (H100 80GB HBM3, 700 W): 0.429 ms on seeded
// main-path operands and 0.49 ms inside the real-data fit step, 9.6x the
// operation bound.  ptxas: 118 registers and a 416-byte stack: the
// per-species arrays ([kMaxSpecies] each, indexed by the run-time S) lived in
// local memory, and 118 registers held an SM to 4 blocks of 4 warps.  Each
// thread read and wrote lf, chi, g_lf and g_chi at stride A (a warp's store
// touched 10 cache lines for 128 useful bytes), met two block barriers per
// (gradient point, angle) to hand t to its neighbour, recomputed its
// neighbour's kinematics and f_e, and ran ~40 IEEE divisions and 4 square
// roots per point, many of them invariant over the angle loop.
//
// This design (one thread per (lineout, wavelength) as before; a block owns
// kOwned wavelengths and its thread 0 is the left halo):
// * The kernel is a template on the number of species S (1..kMaxSpecies,
//   dispatched in the C entry point): every per-species array is in
//   registers.  The Rybicki weights stay in global memory (read only on the
//   rare |x| <= 6 branch of the ions' Dawson function), not in 15 registers.
// * Per gradient point and chunk of at most kMaxChunk angles the block
//   stages its slab -- wavelengths [first - 1, first + kOwned] x the chunk's
//   angles of lf, [first - 1, first + kOwned) of chi; with A <= kMaxChunk
//   one chunk, contiguous in memory -- into shared memory with coalesced
//   asynchronous copies (cp.async), and a pre-pass computes at every slab
//   point, once, k, xi_e and xi_e's two slopes for the by-parts sum.  A
//   thread reads its own point and its right neighbour's from there: the
//   neighbour is no longer recomputed, and both sides of every difference
//   (xi_e[l+1] - xi_e[l], X[l] - X[l+1]) come from one expression.  f_e =
//   exp(lf + lfc) and the Landau difference f_e[l] expm1(lf[l+1] - lf[l]) are
//   formed as spectrum_tail.cu forms them (lf is log f_e less its largest
//   entry lfc): the derivatives of that difference are -f_e[l] and f_e[l+1],
//   as before.
// * The thread keeps g_fe (in its own k's slot) and t per (point, angle) in
//   shared memory; after the chunk's angle loop one barrier, then
//   g_lf = (g_fe + (t[l-1] - t[l])) f_e and g_chi are written out coalesced.
//   One barrier per chunk for the neighbour term instead of two per
//   (gradient point, angle).  The chunks bound the shared memory at ~43 KB
//   a block whatever A is (~36 KB at the main path's A = 10): under the
//   48 KB a block gets without opting in, and 5 blocks fit an SM's 228 KB.
// * Reciprocals of angle-invariant quantities are taken once per lineout,
//   gradient point or species (1/vTe, 1/(sqrt2 vTi), vTi/omega_pi, the
//   omega_pe/(c^2 k_s) chains, 2/omega_L, 1/sqrt(2 pi) ...), and 1/k, 1/klde,
//   1/E2 once per point by the hardware reciprocal (__fdividef: an ulp or two,
//   no IEEE division sequence), multiplied where the chain rule divided.  The
//   by-parts terms and the series forms below keep their own IEEE divisions,
//   expressions and order.
// * __launch_bounds__ keeps 5 blocks an SM resident with one species (the
//   main path), 4 with more, whose per-species registers would spill under
//   the tighter cap.
//
// Two things couple threads:
//
// * The Landau term's spectral difference.  df[l] = (f_e[l+1] - f_e[l]) /
//   (xi_e[l+1] - xi_e[l]), so f_e[l] collects from df[l] and df[l-1]:
//   g_fv[l] = -t[l] + t[l-1] with t = g_df / (xi_e[l+1] - xi_e[l]) (0 at the
//   last wavelength).  Blocks overlap by one wavelength: thread 0 of a block
//   computes the point left of the block's first for its t alone, and owns no
//   output.
// * The small cotangents are sums over wavelengths, angles and (for the
//   per-lineout ones) gradient points.  Each thread sums its own points in
//   float32 registers in a fixed order, a block sums its threads in float64
//   by warp shuffles in a fixed order, and the blocks of one lineout add their
//   partial sums into a zeroed float64 scratch with atomicAdd, in whatever
//   order they finish: in float64 that order moves the float32 results by a
//   last bit at most.  A second, tiny kernel with one thread per lineout
//   turns the sums into the outputs: the chain from omega_L to lam and from
//   vTe to Te, and g_Z, g_Ti, g_fract with the Zbar coupling between species
//   and the icf channel into vTi.
//
// Three sums would cancel in float32 if they were formed term by term as the
// chain rule hands them over; they are formed so that no term cancels:
//
// * xi_e's cotangent from the spectral difference is u[l] - u[l-1] with
//   u = t df, and lam, ne, Te, Va and ud would collect sum_l (u[l] - u[l-1])
//   X[l] with X = d xi_e / d parameter: X varies by 1e-4 of itself between
//   neighbours, so the sum is 1e-4 of its terms.  Summed by parts it is
//   sum_l u[l] (X[l] - X[l+1]), which thread l forms alone from the two
//   points of the slab.  For Te that is g_df df / vTe; for Va and ud X
//   is the same at every wavelength (both shift every xi_e alike), so they get
//   nothing from this chain and g_ud is an exact zero.
// * Re Z' = -2 (1 - 2 xi D) loses every digit to 1 - 2 xi D at the ions' large
//   phase velocities (xi_i ~ 100-1000 away from the ion-acoustic band).  Above
//   |xi| = 6, where D is the asymptotic series, 1 - 2 xi D and the derivative
//   of Z' are the series' own term-by-term forms.
// * g_Ti collects g_kldi kldi - g_xii xii per point, which cancels to
//   3 / (2 xi^2) of either term; above |xi| = 10 its series is summed directly.
//
// The Dawson derivative is analytic, from the same float32 branch as the
// forward: dZ'R = 4 D + 4 xi (1 - 2 xi D), dZ'I = -2 sqrt(pi) e^{-xi^2} (1 - 2 xi^2).

#include "async_copy.cuh"
#include "spectrum_tail_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOwned = kThreads - 1;  // wavelengths a block owns; its thread 0 is the left halo
constexpr int kSlab = kThreads + 1;   // wavelengths of the staged slab: the halo, the owned, one right of them
constexpr int kMaxChunk = 12;         // angles staged at once

// __launch_bounds__' minimum of resident blocks: registers capped at 65536 / (128 x 5) with one species
// (the main path); more species keep more in registers and would spill under that cap
__host__ __device__ constexpr int min_blocks(int S) { return S == 1 ? 5 : 4; }

// Shared floats for chunks of NC angles: per angle, lf, k (then an owner's g_fe), xi_e and its two slopes
// on the slab, chi (then an owner's g_chi) and t per thread; and k_s per slab wavelength.
__host__ __device__ constexpr int smem_floats(int NC) { return (5 * kSlab + 2 * kThreads) * NC + kSlab; }
constexpr size_t kBlockSmem = smem_floats(kMaxChunk) * sizeof(float) + kWarps * sizeof(double);  // + the reduction
static_assert(kBlockSmem <= 48 * 1024, "a block's shared memory must need no opt-in");
static_assert(5 * (kBlockSmem + 1024) <= 228 * 1024, "5 blocks (1 KB each reserved) must fit an SM");

// Sum v over the block (fixed order, float64) and add the sum to *dst.
__device__ __forceinline__ void block_add(float value, double* dst, double* red) {
  double v = static_cast<double>(value);
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(0xffffffffu, v, offset);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    atomicAdd(dst, s);
  }
  __syncthreads();
}

// 1 - 2 x D(x) and d Re Z'/dx = 4 D + 4 x (1 - 2 x D).  Above |x| = 6, where
// D = S / (2 x) with S = sum_n (2n-1)!! s^n, s = 1 / (2 x^2), both are the
// series' own forms: 1 - S, and -(4 s / x) sum_n n (2n-1)!! s^(n-1).
__device__ __forceinline__ void zprime_real(float x, const float* __restrict__ gauss, float sqrt_pi, float* om2xd,
                                            float* dZpR) {
  if (fabsf(x) > 6.0f) {
    const float s = 1.0f / (2.0f * x * x);
    *om2xd = -s * (1.0f + s * (3.0f + s * (15.0f + s * (105.0f + s * (945.0f + s * 10395.0f)))));
    *dZpR = -(4.0f * s / x) * (1.0f + s * (6.0f + s * (45.0f + s * (420.0f + s * (4725.0f + s * 62370.0f)))));
  } else {
    const float D = dawsn_f32(x, gauss, sqrt_pi);
    *om2xd = 1.0f - 2.0f * x * D;
    *dZpR = 4.0f * D + 4.0f * x * *om2xd;
  }
}

// d xi_e / d omega_L and d xi_e / d omega_pe at one point, both times vTe:
// xi_e = (om - omgL) / (k vTe) - (Va + ud) / vTe with k = k(ks(om, omgpe), kL(omgL, omgpe)).
__device__ __forceinline__ void xie_slopes(float om, float ks, float k, float omgL, float kL, float omgpe, float cth,
                                           float c2, float* x_omgL, float* x_omgpe) {
  const float x_k = -(om - omgL) / (k * k);
  const float dk_dks = (ks - kL * cth) / k;
  const float dk_dkL = (kL - ks * cth) / k;
  *x_omgL = -1.0f / k + x_k * dk_dkL * (omgL / (c2 * kL));
  *x_omgpe = x_k * (dk_dks * (-omgpe / (c2 * ks)) + dk_dkL * (-omgpe / (c2 * kL)));
}

// Offsets into one lineout's row of the float64 sums: a_ne and a_vTe per
// gradient point, a_omgL, a_Va, then a_icf, a_ti, a_kld per species.
__host__ __device__ __forceinline__ int sums_per_lineout(int G, int S) { return 2 * G + 2 + 3 * S; }

template <int S>
__global__ void __launch_bounds__(kThreads, min_blocks(S)) spectrum_tail_bwd_kernel(
    const float* __restrict__ lf, const float* __restrict__ chi, const float* __restrict__ ne,
    const float* __restrict__ Te, const float* __restrict__ lam, const float* __restrict__ Va,
    const float* __restrict__ ud, const float* __restrict__ Am, const float* __restrict__ Z,
    const float* __restrict__ Ti, const float* __restrict__ fract, const float* __restrict__ cos_sa,
    const float* __restrict__ weight, const float* __restrict__ omgs, const float* __restrict__ gauss,
    const float* __restrict__ lfc, const float* __restrict__ gout, float* __restrict__ g_lf,
    float* __restrict__ g_chi, double* __restrict__ sums, int G, int L, int NA, int NC) {
  // laid out for chunks of NC angles; a chunk of nc <= NC angles uses [rows][nc] of each
  extern __shared__ float smem[];
  float* lf_s = smem;                  // [kSlab][nc]
  float* k_s = lf_s + kSlab * NC;      // [kSlab][nc]: k, then an owner's g_fe (k is read by its own thread alone)
  float* xie_s = k_s + kSlab * NC;     // [kSlab][nc]
  float* xL_s = xie_s + kSlab * NC;    // [kSlab][nc]: d xi_e / d omega_L times vTe
  float* xpe_s = xL_s + kSlab * NC;    // [kSlab][nc]: d xi_e / d omega_pe times vTe
  float* chi_s = xpe_s + kSlab * NC;   // [kThreads][nc]: chi, then an owner's g_chi
  float* t_s = chi_s + kThreads * NC;  // [kThreads][nc]
  float* ks_s = t_s + kThreads * NC;   // [kSlab]
  __shared__ double red[kWarps];

  const int b = blockIdx.y;
  const int tid = static_cast<int>(threadIdx.x);
  const int first = static_cast<int>(blockIdx.x) * kOwned;  // the block's first owned wavelength
  const int l_raw = first + tid - 1;
  const bool in_range = l_raw >= 0 && l_raw < L;
  const bool owner = in_range && tid > 0;
  const int l = min(max(l_raw, 0), L - 1);  // out-of-range threads compute a valid point and discard it
  const int ic = l - (first - 1);           // its slab index, in [0, kThreads)
  const int owned = min(kOwned, L - first);

  const Consts K = make_consts();
  const bool has_next = l + 1 < L;
  const float lamb = lam[b];
  const float omgL = K.omgl_num / lamb;
  const float two_over_omgL = 2.0f / omgL;
  const float m2_over_omgL2 = -2.0f / (omgL * omgL);
  const float va = Va[b];
  const float udb = ud[b];
  const float lfc_b = lfc[b];
  const float om = omgs[l];
  const float om_n = has_next ? omgs[l + 1] : om;
  const float wl = om * om / (2.0f * K.pi * K.c);  // 2 pi c / lams^2 with lams = 2 pi c / om
  const float gl_re2 = gout[static_cast<size_t>(b) * L + l] * wl * K.re2 / static_cast<float>(G);
  const float c2 = K.c * K.c;
  const float inv_sqrt_2pi = static_cast<float>(1.0 / sqrt(2.0 * kPi));

  float zs[S], frs[S], vti[S], icf[S], inv_s2vti[S];
  float a_icf[S], a_ti[S], a_kld[S];
  float zbar = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    zs[s] = Z[b * S + s];
    frs[s] = fract[b * S + s];
    zbar += zs[s] * frs[s];
    a_icf[s] = a_ti[s] = a_kld[s] = 0.0f;
  }
  float mis[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    mis[s] = Am[b * S + s] * K.mp;
    vti[s] = sqrtf(Ti[b * S + s] / mis[s]);
    icf[s] = frs[s] * (zs[s] * zs[s]) / zbar / vti[s];
    inv_s2vti[s] = 1.0f / (K.sqrt2 * vti[s]);
  }

  double* row = sums + static_cast<size_t>(b) * sums_per_lineout(G, S);
  float a_omgL = 0.0f, a_Va = 0.0f;
  for (int g = 0; g < G; ++g) {
    const float ne_g = ne[b * G + g];
    const float omgpe = K.pfc * sqrtf(ne_g);
    const float kL = sqrtf(omgL * omgL - omgpe * omgpe) / K.c;
    const float vTe = sqrtf(Te[b * G + g] / K.me);
    const float ud_vTe = udb / vTe;

    // ---- per (lineout, gradient point) and per species: everything the angle loop does not change
    const float ks = sqrtf(om * om - omgpe * omgpe) / K.c;
    const float inv_vTe = 1.0f / vTe;
    const float inv_omgpe = 1.0f / omgpe;
    const float vTe_over_omgpe = vTe / omgpe;
    const float vTe_over_omgpe2 = vTe / (omgpe * omgpe);
    const float c_ks = -omgpe / (c2 * ks);
    const float c_kL = -omgpe / (c2 * kL);
    const float omgL_c2kL = omgL / (c2 * kL);
    const float inv_2ne = 1.0f / (2.0f * ne_g);
    const float omgpe_2ne = omgpe * inv_2ne;
    float vti_omgpi[S], omgpi_vti2[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float ni = frs[s] * ne_g / zbar;
      const float omgpi = K.pfc * zs[s] * sqrtf(ni * K.me / mis[s]);
      vti_omgpi[s] = vti[s] / omgpi;
      omgpi_vti2[s] = 1.0f / (vti_omgpi[s] * vti_omgpi[s]);
    }
    float a_ne = 0.0f, a_vTe = 0.0f;
    const size_t row0 = static_cast<size_t>(b * G + g) * L * NA;  // this (lineout, gradient point)'s first entry

    for (int a0 = 0; a0 < NA; a0 += NC) {
      const int nc = min(NC, NA - a0);  // this chunk's angles: a0 .. a0 + nc - 1

      // ---- the slab: lf and chi in, coalesced; then k, xi_e and its slopes at every slab point
      __syncthreads();  // the previous chunk's slab is consumed
      SlabWalk<kThreads> w(tid, nc);
      for (int e = tid; e < kSlab * nc; e += kThreads, w.next()) {
        const int li = first - 1 + w.row;
        const bool ok = li >= 0 && li < L;
        const size_t src = ok ? row0 + static_cast<size_t>(li) * NA + a0 + w.col : 0;
        copy_async(lf_s + e, lf + src, ok);
        if (e < kThreads * nc) copy_async(chi_s + e, chi + src, ok);
      }
      for (int i = tid; i < kSlab; i += kThreads) {
        const int li = min(max(first - 1 + i, 0), L - 1);
        ks_s[i] = sqrtf(omgs[li] * omgs[li] - omgpe * omgpe) / K.c;
      }
      copies_done();
      __syncthreads();
      w = SlabWalk<kThreads>(tid, nc);
      for (int e = tid; e < kSlab * nc; e += kThreads, w.next()) {  // entry by entry: every thread takes ~nc of them
        const int i = w.row, li = first - 1 + i;
        if (li < 0 || li >= L) continue;
        const float om_i = omgs[li];
        const float ks_i = ks_s[i];
        const float cth = cos_sa[a0 + w.col];
        const float k = sqrtf(ks_i * ks_i + kL * kL - 2.0f * ks_i * kL * cth);
        k_s[e] = k;
        xie_s[e] = ((om_i - omgL) - k * va) / (k * vTe) - ud_vTe;
        xie_slopes(om_i, ks_i, k, omgL, kL, omgpe, cth, c2, &xL_s[e], &xpe_s[e]);
      }
      __syncthreads();

      for (int a = 0; a < nc; ++a) {
        // ---- the forward at this point, as spectrum_tail.cu computes it
        const float cth = cos_sa[a0 + a];
        const int e = ic * nc + a;
        // an owner's k is its own slot; a thread outside the owned range recomputes its point's k (the same
        // expression), as the owner of that slot may already have put its g_fe there
        const float k = owner ? k_s[e] : sqrtf(ks * ks + kL * kL - 2.0f * ks * kL * cth);
        const float xie = xie_s[e];
        const float lfv = lf_s[e];
        const float fe = expf(lfv + lfc_b);
        const float inv_k = __fdividef(1.0f, k);  // not a by-parts or series term: its rounding is free
        const float omgdop = (om - omgL) - k * va;
        const float klde = vTe_over_omgpe * k;
        float rinv = 0.0f, df = 0.0f;
        if (has_next) {
          rinv = 1.0f / (xie_s[e + nc] - xie);
          df = fe * expm1f(lf_s[e + nc] - lfv) * rinv;  // f_e[l+1] - f_e[l], as spectrum_tail.cu forms it
        }
        const float chi_v = owner ? chi_s[tid * nc + a] : chi[row0 + static_cast<size_t>(l) * NA + a0 + a];
        const float inv_klde = __fdividef(1.0f, klde);
        const float iklde2 = inv_klde * inv_klde;
        const float ceR = -iklde2 * chi_v;
        const float ceI = -K.pi * iklde2 * df;
        const float od_k = omgdop * inv_k;
        const float inv_k2 = inv_k * inv_k;

        float ciR = 0.0f, ciI = 0.0f, SA = 0.0f;
        float xii_s[S], om2xd_s[S], dZpR_s[S], ex2_s[S], ik2_s[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float xii = od_k * inv_s2vti[s];
          zprime_real(xii, gauss, K.sqrt_pi, &om2xd_s[s], &dZpR_s[s]);
          const float ex2 = expf(-(xii * xii));
          const float ik2 = omgpi_vti2[s] * inv_k2;  // 1 / kldi^2, kldi = (vTi / omega_pi) k
          ciR += -0.5f * ik2 * (-2.0f * om2xd_s[s]);
          ciI += -0.5f * ik2 * (-2.0f * K.sqrt_pi * xii * ex2);
          SA += icf[s] * (ex2 * inv_sqrt_2pi);
          xii_s[s] = xii;
          ex2_s[s] = ex2;
          ik2_s[s] = ik2;
        }

        const float epsR = 1.0f + ceR + ciR;
        const float epsI = ceI + ciI;
        const float E2 = epsR * epsR + epsI * epsI;
        const float AE2 = ceR * ceR + ceI * ceI;
        const float BI2 = (1.0f + ciR) * (1.0f + ciR) + ciI * ciI;
        const float inv_E2 = __fdividef(1.0f, E2);
        const float base = inv_k * inv_E2;  // 1 / (k E2)
        const float fe_vTe = fe * inv_vTe;
        const float ele_over_vTe = BI2 * fe_vTe;
        const float SKW = (AE2 * SA + ele_over_vTe) * base;
        const float w2 = 1.0f + omgdop * two_over_omgL;

        // ---- assembly backward: out = sum_a weight[a] mean_g SKW w2 re^2 ne wl
        const float gs = gl_re2 * weight[a0 + a];
        const float gS = gs * w2 * ne_g;
        const float g_w2 = gs * SKW * ne_g;
        const float g_omgdop = g_w2 * two_over_omgL;
        const float gSb = gS * base;
        const float g_AE2 = gSb * SA;
        const float g_SA = gSb * AE2;
        const float g_BI2 = gSb * fe_vTe;
        const float g_fe = gSb * (BI2 * inv_vTe);
        const float g_base = gS * (AE2 * SA + ele_over_vTe);
        const float g_k = -g_base * base * inv_k;
        const float g_E2 = -g_base * base * inv_E2;
        const float g_epsR = 2.0f * epsR * g_E2;
        const float g_epsI = 2.0f * epsI * g_E2;
        const float g_ceR = g_epsR + 2.0f * ceR * g_AE2;
        const float g_ceI = g_epsI + 2.0f * ceI * g_AE2;
        const float g_ciR = g_epsR + 2.0f * (1.0f + ciR) * g_BI2;
        const float g_ciI = g_epsI + 2.0f * ciI * g_BI2;

        // ---- electron susceptibility and the spectral difference
        const float g_df = -K.pi * iklde2 * g_ceI;
        const float g_iklde2 = -g_ceR * chi_v - K.pi * df * g_ceI;
        const float g_klde = -2.0f * g_iklde2 * iklde2 * inv_klde;
        const float t = g_df * rinv;  // rinv is 0 at the last wavelength: df there is a constant 0
        t_s[tid * nc + a] = in_range ? t : 0.0f;
        if (!owner) continue;
        chi_s[tid * nc + a] = -g_ceR * iklde2;  // g_chi, in the slot this thread alone reads
        k_s[tid * nc + a] = g_fe;               // its k's slot, read by this thread alone

        // ---- ion susceptibility chain
        float g_omgdop_i = 0.0f, g_k_i = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float xii = xii_s[s], ex2 = ex2_s[s], ik2 = ik2_s[s];
          const float ZpR = -2.0f * om2xd_s[s];
          const float ZpI = -2.0f * K.sqrt_pi * xii * ex2;
          const float dZpI = -2.0f * K.sqrt_pi * ex2 * (1.0f - 2.0f * xii * xii);
          const float g2 = ex2 * inv_sqrt_2pi;
          // g_kldi kldi and g_xii, each split into the part through Re Z' and the rest
          const float gk_re = ZpR * g_ciR * ik2;
          const float gk_rest = ZpI * g_ciI * ik2;
          const float gx_re = (-0.5f * ik2 * g_ciR) * dZpR_s[s];
          const float gx_rest = g_SA * (icf[s] * -2.0f * xii) * g2 + (-0.5f * ik2 * g_ciI) * dZpI;
          const float gk_kld = gk_re + gk_rest;
          const float g_xii = gx_re + gx_rest;
          // g_kldi kldi - g_xii xii: far out its Re Z' part is the difference of the two series of
          // zprime_real, -g_ciR ik2 s^2 (6 + 60 s + ...), whose own terms only fall off fast enough above |xi| ~ 10
          float comb_re = gk_re - gx_re * xii;
          if (fabsf(xii) > 10.0f) {
            const float sq = 1.0f / (2.0f * xii * xii);
            comb_re = -g_ciR * ik2 * sq * sq * (6.0f + sq * (60.0f + sq * (630.0f + sq * (7560.0f + sq * 103950.0f))));
          }
          const float comb = comb_re + (gk_rest - gx_rest * xii);
          g_omgdop_i += g_xii * (inv_s2vti[s] * inv_k);  // xii = (omgdop / k) / (sqrt2 vTi)
          g_k_i += comb * inv_k;                          // kldi = vTi k / omgpi
          a_icf[s] += g_SA * g2;
          a_ti[s] += comb;
          a_kld[s] += gk_kld;
          a_ne -= gk_kld * inv_2ne;  // omgpi ~ sqrt(ne)
        }

        // ---- kinematics backward, without xi_e's cotangent from the spectral difference
        const float gd_tot = g_omgdop + g_omgdop_i;
        const float gk_tot = (g_k + g_k_i) - va * gd_tot + g_klde * vTe_over_omgpe;
        const float dk_dks = (ks - kL * cth) * inv_k;
        const float dk_dkL = (kL - ks * cth) * inv_k;
        float g_omgpe = gk_tot * (dk_dks * c_ks + dk_dkL * c_kL) - g_klde * (vTe_over_omgpe2 * k);
        float g_omgL = g_w2 * (m2_over_omgL2 * omgdop) - gd_tot + gk_tot * dk_dkL * omgL_c2kL;
        // ---- that cotangent, summed by parts: u[l] (X[l] - X[l+1]) with u = t df
        if (has_next) {
          const float u_over_vTe = t * df / vTe;
          g_omgL += u_over_vTe * (xL_s[e] - xL_s[e + nc]);
          g_omgpe += u_over_vTe * (xpe_s[e] - xpe_s[e + nc]);
        }
        a_ne += gs * SKW * w2 + g_omgpe * omgpe_2ne;
        a_vTe += -gS * ele_over_vTe * base * inv_vTe + g_klde * (k * inv_omgpe) + g_df * df / vTe;
        a_omgL += g_omgL;
        a_Va += gd_tot * (-k);
      }

      // ---- g_lf = (g_fe + (t[l-1] - t[l])) f_e and g_chi over the owned wavelengths, coalesced
      __syncthreads();
      float* out_lf = g_lf + row0 + static_cast<size_t>(first) * NA + a0;
      float* out_chi = g_chi + row0 + static_cast<size_t>(first) * NA + a0;
      w = SlabWalk<kThreads>(tid, nc);
      for (int e = tid; e < owned * nc; e += kThreads, w.next()) {
        const int p = e + nc;  // the owning thread's entry: thread w.row + 1
        const size_t d = static_cast<size_t>(w.row) * NA + w.col;
        // f_e again from lf, which stays staged for the neighbour's expm1: on the H100 a variant that kept each
        // owner's f_e in its lf slot (the expm1 taken in the pre-pass) ran ~1 % slower than this expf
        out_lf[d] = (k_s[p] + (t_s[e] - t_s[p])) * expf(lf_s[p] + lfc_b);
        out_chi[d] = chi_s[p];
      }
    }
    block_add(a_ne, row + g, red);
    block_add(a_vTe, row + G + g, red);
  }
  block_add(a_omgL, row + 2 * G, red);
  block_add(a_Va, row + 2 * G + 1, red);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    block_add(a_icf[s], row + 2 * G + 2 + s, red);
    block_add(a_ti[s], row + 2 * G + 2 + S + s, red);
    block_add(a_kld[s], row + 2 * G + 2 + 2 * S + s, red);
  }
}

// One thread per lineout: the small cotangents from the float64 sums.  g_ne is
// its sum; g_Te = a_vTe / (2 vTe me); g_lam = a_omgL d omega_L / d lam; g_Va
// is its sum and g_ud is 0.  With icf = fract Z^2 / (Zbar vTi) and
// omgpi = comg sqrt(ne), comg = pfc Z sqrt(fract me / (Mi Zbar)), the comg
// factors of the species cotangents cancel:
//   g_vTi   = (sum (g_kldi kldi - g_xii xii) - g_icf icf) / vTi
//   g_Z     = (-sum g_kldi kldi + 2 g_icf icf) / Z     + g_Zbar fract
//   g_fract = (-sum g_kldi kldi / 2 + g_icf icf) / fract + g_Zbar Z
//   g_Zbar  = sum_s (sum g_kldi kldi / 2 - g_icf icf) / Zbar
template <int S>
__global__ void spectrum_tail_bwd_finish_kernel(const float* __restrict__ Te, const float* __restrict__ lam,
                                                const float* __restrict__ Am, const float* __restrict__ Z,
                                                const float* __restrict__ Ti, const float* __restrict__ fract,
                                                const double* __restrict__ sums, float* __restrict__ g_ne,
                                                float* __restrict__ g_Te, float* __restrict__ g_lam,
                                                float* __restrict__ g_Va, float* __restrict__ g_ud,
                                                float* __restrict__ g_Z, float* __restrict__ g_Ti,
                                                float* __restrict__ g_fract, int B, int G) {
  const int b = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const double* row = sums + static_cast<size_t>(b) * sums_per_lineout(G, S);
  for (int g = 0; g < G; ++g) {
    const double vTe = sqrt(static_cast<double>(Te[b * G + g]) / kMe);
    g_ne[b * G + g] = static_cast<float>(row[g]);
    g_Te[b * G + g] = static_cast<float>(row[G + g] / (2.0 * vTe * kMe));
  }
  const double lamb = static_cast<double>(lam[b]);
  g_lam[b] = static_cast<float>(row[2 * G] * (-(2.0 * kPi * 1.0e7 * kC) / (lamb * lamb)));
  g_Va[b] = static_cast<float>(row[2 * G + 1]);
  g_ud[b] = 0.0f;

  const double* a_icf = row + 2 * G + 2;
  const double* a_ti = a_icf + S;
  const double* a_kld = a_ti + S;
  double zbar = 0.0;
#pragma unroll
  for (int s = 0; s < S; ++s) zbar += static_cast<double>(Z[b * S + s]) * static_cast<double>(fract[b * S + s]);
  double gi[S];  // g_icf icf
  double g_zbar = 0.0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double z = Z[b * S + s], fr = fract[b * S + s];
    const double vti = sqrt(Ti[b * S + s] / (Am[b * S + s] * kMp));
    gi[s] = a_icf[s] * (fr * (z * z) / zbar / vti);
    g_zbar += (0.5 * a_kld[s] - gi[s]) / zbar;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double z = Z[b * S + s], fr = fract[b * S + s];
    const double mi = Am[b * S + s] * kMp;
    const double vti = sqrt(Ti[b * S + s] / mi);
    g_Ti[b * S + s] = static_cast<float>(((a_ti[s] - gi[s]) / vti) / (2.0 * vti * mi));
    g_Z[b * S + s] = static_cast<float>((2.0 * gi[s] - a_kld[s]) / z + g_zbar * fr);
    g_fract[b * S + s] = static_cast<float>((gi[s] - 0.5 * a_kld[s]) / fr + g_zbar * z);
  }
}

struct Args {
  const float *lf, *chi, *ne, *Te, *lam, *Va, *ud, *A, *Z, *Ti, *fract, *cos_sa, *weight, *omgs, *gauss, *lfc, *gout;
  float *g_lf, *g_chi, *g_ne, *g_Te, *g_lam, *g_Va, *g_ud, *g_Z, *g_Ti, *g_fract;
  double* sums;
  int B, G, L, NA;
  cudaStream_t stream;
};

template <int S>
int launch(const Args& x) {
  // the angles in chunks of at most kMaxChunk, as even as they go
  const int chunks = x.NA > kMaxChunk ? (x.NA + kMaxChunk - 1) / kMaxChunk : 1;
  const int NC = (x.NA + chunks - 1) / chunks;
  const size_t smem = static_cast<size_t>(smem_floats(NC)) * sizeof(float);
  const dim3 grid((x.L + kOwned - 1) / kOwned, x.B);
  spectrum_tail_bwd_kernel<S><<<grid, kThreads, smem, x.stream>>>(
      x.lf, x.chi, x.ne, x.Te, x.lam, x.Va, x.ud, x.A, x.Z, x.Ti, x.fract, x.cos_sa, x.weight, x.omgs, x.gauss,
      x.lfc, x.gout, x.g_lf, x.g_chi, x.sums, x.G, x.L, x.NA, NC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spectrum_tail_bwd_finish_kernel<S><<<(x.B + 127) / 128, 128, 0, x.stream>>>(
      x.Te, x.lam, x.A, x.Z, x.Ti, x.fract, x.sums, x.g_ne, x.g_Te, x.g_lam, x.g_Va, x.g_ud, x.g_Z, x.g_Ti,
      x.g_fract, x.B, x.G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sums [B, 2 G + 2 + 3 S] float64 must arrive zeroed; every output is written
// in full.
extern "C" int spectrum_tail_bwd(const void* lf, const void* chi, const void* ne, const void* Te, const void* lam,
                                 const void* Va, const void* ud, const void* A, const void* Z, const void* Ti,
                                 const void* fract, const void* cos_sa, const void* weight, const void* omgs,
                                 const void* gauss, const void* lfc, const void* gout, void* g_lf, void* g_chi,
                                 void* g_ne,
                                 void* g_Te, void* g_lam, void* g_Va, void* g_ud, void* g_Z, void* g_Ti,
                                 void* g_fract, void* sums, int B, int G, int L, int NA, int S, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  const Args x{f(lf), f(chi), f(ne), f(Te), f(lam), f(Va), f(ud), f(A), f(Z), f(Ti), f(fract), f(cos_sa),
               f(weight), f(omgs), f(gauss), f(lfc), f(gout), m(g_lf), m(g_chi), m(g_ne), m(g_Te), m(g_lam), m(g_Va),
               m(g_ud), m(g_Z), m(g_Ti), m(g_fract), static_cast<double*>(sums), B, G, L, NA,
               static_cast<cudaStream_t>(stream)};
  switch (S) {
    case 1: return launch<1>(x);
    case 2: return launch<2>(x);
    case 3: return launch<3>(x);
    case 4: return launch<4>(x);
    case 5: return launch<5>(x);
    case 6: return launch<6>(x);
    case 7: return launch<7>(x);
    case 8: return launch<8>(x);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
