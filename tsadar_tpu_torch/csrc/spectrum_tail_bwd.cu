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
// much again for the chain rule, ~25 transcendental and ~450 other f32
// operations per point and species: near the ridge, as the forward is.
//
// Design.  One thread owns one (lineout, wavelength) and loops over gradient
// points and angles with every intermediate in registers, as the forward
// does.  Two things couple threads:
//
// * The Landau term's spectral difference.  df[l] = (f_e[l+1] - f_e[l]) /
//   (xi_e[l+1] - xi_e[l]), so f_e[l] collects from df[l] and df[l-1]:
//   g_fv[l] = -t[l] + t[l-1] with t = g_df / (xi_e[l+1] - xi_e[l]) (0 at the
//   last wavelength).  t depends on the whole assembly at its wavelength, so
//   threads hand it to their right neighbour through shared memory, and
//   blocks overlap by one wavelength: thread 0 of a block recomputes the
//   point left of the block's first for its t alone, and owns no output.
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
//   points it computes anyway.  For Te that is g_df df / vTe; for Va and ud X
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

#include "spectrum_tail_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOwned = kThreads - 1;  // wavelengths a block owns; its thread 0 is the left halo

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
__device__ __forceinline__ int sums_per_lineout(int G, int S) { return 2 * G + 2 + 3 * S; }

__global__ void spectrum_tail_bwd_kernel(
    const float* __restrict__ lf, const float* __restrict__ chi, const float* __restrict__ ne,
    const float* __restrict__ Te, const float* __restrict__ lam, const float* __restrict__ Va,
    const float* __restrict__ ud, const float* __restrict__ Am, const float* __restrict__ Z,
    const float* __restrict__ Ti, const float* __restrict__ fract, const float* __restrict__ cos_sa,
    const float* __restrict__ weight, const float* __restrict__ omgs, const float* __restrict__ gauss_in,
    const float* __restrict__ gout, float* __restrict__ g_lf, float* __restrict__ g_chi, double* __restrict__ sums,
    int G, int L, int NA, int S) {
  __shared__ float s_t[kThreads];
  __shared__ double red[kWarps];

  const int b = blockIdx.y;
  const int tid = static_cast<int>(threadIdx.x);
  const int l_raw = static_cast<int>(blockIdx.x) * kOwned + tid - 1;
  const bool in_range = l_raw >= 0 && l_raw < L;
  const bool owner = in_range && tid > 0;
  const int l = min(max(l_raw, 0), L - 1);  // out-of-range threads compute a valid point and discard it

  const Consts K = make_consts();
  float gauss[kNJ];
#pragma unroll
  for (int jj = 0; jj < kNJ; ++jj) gauss[jj] = gauss_in[jj];

  const bool has_next = l + 1 < L;
  const float lamb = lam[b];
  const float omgL = K.omgl_num / lamb;
  const float va = Va[b];
  const float udb = ud[b];
  const float om = omgs[l];
  const float om_n = has_next ? omgs[l + 1] : om;
  const float wl = om * om / (2.0f * K.pi * K.c);  // 2 pi c / lams^2 with lams = 2 pi c / om
  const float gl = gout[static_cast<size_t>(b) * L + l];
  const float c2 = K.c * K.c;

  float zs[kMaxSpecies], frs[kMaxSpecies], mis[kMaxSpecies], vti[kMaxSpecies], icf[kMaxSpecies];
  float a_icf[kMaxSpecies], a_ti[kMaxSpecies], a_kld[kMaxSpecies];
  float zbar = 0.0f;
  for (int s = 0; s < S; ++s) {
    zs[s] = Z[b * S + s];
    frs[s] = fract[b * S + s];
    zbar += zs[s] * frs[s];
    a_icf[s] = a_ti[s] = a_kld[s] = 0.0f;
  }
  for (int s = 0; s < S; ++s) {
    mis[s] = Am[b * S + s] * K.mp;
    vti[s] = sqrtf(Ti[b * S + s] / mis[s]);
    icf[s] = frs[s] * (zs[s] * zs[s]) / zbar / vti[s];
  }

  double* row = sums + static_cast<size_t>(b) * sums_per_lineout(G, S);
  float a_omgL = 0.0f, a_Va = 0.0f;
  for (int g = 0; g < G; ++g) {
    const float ne_g = ne[b * G + g];
    const float omgpe = K.pfc * sqrtf(ne_g);
    const float ks = sqrtf(om * om - omgpe * omgpe) / K.c;
    const float ks_n = sqrtf(om_n * om_n - omgpe * omgpe) / K.c;
    const float kL = sqrtf(omgL * omgL - omgpe * omgpe) / K.c;
    const float vTe = sqrtf(Te[b * G + g] / K.me);
    float a_ne = 0.0f, a_vTe = 0.0f;

    for (int a = 0; a < NA; ++a) {
      // ---- the forward at this point, as spectrum_tail.cu computes it
      const float cth = cos_sa[a];
      const float k = sqrtf(ks * ks + kL * kL - 2.0f * ks * kL * cth);
      const float omgdop = (om - omgL) - k * va;
      const float klde = (vTe / omgpe) * k;
      const float xie = omgdop / (k * vTe) - udb / vTe;

      const size_t idx = ((static_cast<size_t>(b) * G + g) * L + l) * NA + a;
      const float fe = expf(lf[idx]);
      float k_n = k, rinv = 0.0f, df = 0.0f;
      if (has_next) {
        k_n = sqrtf(ks_n * ks_n + kL * kL - 2.0f * ks_n * kL * cth);
        const float xie_n = ((om_n - omgL) - k_n * va) / (k_n * vTe) - udb / vTe;
        rinv = 1.0f / (xie_n - xie);
        df = (expf(lf[idx + NA]) - fe) * rinv;
      }
      const float chi_v = chi[idx];
      const float iklde2 = 1.0f / (klde * klde);
      const float ceR = -iklde2 * chi_v;
      const float ceI = -K.pi * iklde2 * df;

      float ciR = 0.0f, ciI = 0.0f, SA = 0.0f;
      float xii_s[kMaxSpecies], om2xd_s[kMaxSpecies], dZpR_s[kMaxSpecies], ex2_s[kMaxSpecies], ik2_s[kMaxSpecies];
      for (int s = 0; s < S; ++s) {
        const float ni = frs[s] * ne_g / zbar;
        const float omgpi = K.pfc * zs[s] * sqrtf(ni * K.me / mis[s]);
        const float kldi = (vti[s] / omgpi) * k;
        const float xii = (omgdop / k) / (K.sqrt2 * vti[s]);
        zprime_real(xii, gauss, K.sqrt_pi, &om2xd_s[s], &dZpR_s[s]);
        const float ex2 = expf(-(xii * xii));
        const float ik2 = 1.0f / (kldi * kldi);
        ciR += -0.5f * ik2 * (-2.0f * om2xd_s[s]);
        ciI += -0.5f * ik2 * (-2.0f * K.sqrt_pi * xii * ex2);
        SA += icf[s] * (ex2 / K.sqrt_2pi);
        xii_s[s] = xii;
        ex2_s[s] = ex2;
        ik2_s[s] = ik2;
      }

      const float epsR = 1.0f + ceR + ciR;
      const float epsI = ceI + ciI;
      const float E2 = epsR * epsR + epsI * epsI;
      const float AE2 = ceR * ceR + ceI * ceI;
      const float BI2 = (1.0f + ciR) * (1.0f + ciR) + ciI * ciI;
      const float base = 1.0f / (k * E2);
      const float ele_over_vTe = BI2 * fe / vTe;
      const float SKW = (AE2 * SA + ele_over_vTe) * base;
      const float w2 = 1.0f + 2.0f * omgdop / omgL;

      // ---- assembly backward: out = sum_a weight[a] mean_g SKW w2 re^2 ne wl
      const float gs = gl * (weight[a] / static_cast<float>(G)) * wl * K.re2;
      const float gS = gs * w2 * ne_g;
      const float g_w2 = gs * SKW * ne_g;
      const float g_omgdop = g_w2 * (2.0f / omgL);
      const float g_AE2 = gS * SA * base;
      const float g_SA = gS * AE2 * base;
      const float g_BI2 = gS * (fe / vTe) * base;
      const float g_fe = gS * (BI2 / vTe) * base;
      const float g_base = gS * (AE2 * SA + ele_over_vTe);
      const float g_k = -g_base * base / k;
      const float g_E2 = -g_base * base / E2;
      const float g_epsR = 2.0f * epsR * g_E2;
      const float g_epsI = 2.0f * epsI * g_E2;
      const float g_ceR = g_epsR + 2.0f * ceR * g_AE2;
      const float g_ceI = g_epsI + 2.0f * ceI * g_AE2;
      const float g_ciR = g_epsR + 2.0f * (1.0f + ciR) * g_BI2;
      const float g_ciI = g_epsI + 2.0f * ciI * g_BI2;

      // ---- electron susceptibility and the spectral difference
      const float g_df = -K.pi * iklde2 * g_ceI;
      const float g_iklde2 = -g_ceR * chi_v - K.pi * df * g_ceI;
      const float g_klde = -2.0f * g_iklde2 * iklde2 / klde;
      const float t = g_df * rinv;  // rinv is 0 at the last wavelength: df there is a constant 0
      s_t[tid] = in_range ? t : 0.0f;
      __syncthreads();
      const float t_prev = tid > 0 ? s_t[tid - 1] : 0.0f;
      __syncthreads();
      if (!owner) continue;  // trip counts are uniform: every thread still reaches both barriers

      g_chi[idx] = -g_ceR * iklde2;
      g_lf[idx] = (g_fe + (t_prev - t)) * fe;

      // ---- ion susceptibility chain
      float g_omgdop_i = 0.0f, g_k_i = 0.0f;
      for (int s = 0; s < S; ++s) {
        const float xii = xii_s[s], ex2 = ex2_s[s], ik2 = ik2_s[s];
        const float ZpR = -2.0f * om2xd_s[s];
        const float ZpI = -2.0f * K.sqrt_pi * xii * ex2;
        const float dZpI = -2.0f * K.sqrt_pi * ex2 * (1.0f - 2.0f * xii * xii);
        const float g2 = ex2 / K.sqrt_2pi;
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
        g_omgdop_i += g_xii / ((K.sqrt2 * vti[s]) * k);  // xii = (omgdop / k) / (sqrt2 vTi)
        g_k_i += comb / k;                               // kldi = vTi k / omgpi
        a_icf[s] += g_SA * g2;
        a_ti[s] += comb;
        a_kld[s] += gk_kld;
        a_ne -= gk_kld / (2.0f * ne_g);  // omgpi ~ sqrt(ne)
      }

      // ---- kinematics backward, without xi_e's cotangent from the spectral difference
      const float gd_tot = g_omgdop + g_omgdop_i;
      const float gk_tot = (g_k + g_k_i) - va * gd_tot + g_klde * (vTe / omgpe);
      const float dk_dks = (ks - kL * cth) / k;
      const float dk_dkL = (kL - ks * cth) / k;
      float g_omgpe = gk_tot * (dk_dks * (-omgpe / (c2 * ks)) + dk_dkL * (-omgpe / (c2 * kL))) +
                      g_klde * (-vTe * k / (omgpe * omgpe));
      float g_omgL = g_w2 * ((-2.0f / (omgL * omgL)) * omgdop) - gd_tot + gk_tot * dk_dkL * (omgL / (c2 * kL));
      // ---- that cotangent, summed by parts: u[l] (X[l] - X[l+1]) with u = t df
      if (has_next) {
        float xL, xpe, xL_n, xpe_n;
        xie_slopes(om, ks, k, omgL, kL, omgpe, cth, c2, &xL, &xpe);
        xie_slopes(om_n, ks_n, k_n, omgL, kL, omgpe, cth, c2, &xL_n, &xpe_n);
        const float u_over_vTe = t * df / vTe;
        g_omgL += u_over_vTe * (xL - xL_n);
        g_omgpe += u_over_vTe * (xpe - xpe_n);
      }
      a_ne += gs * SKW * w2 + g_omgpe * (omgpe / (2.0f * ne_g));
      a_vTe += -gS * ele_over_vTe * base / vTe + g_klde * (k / omgpe) + g_df * df / vTe;
      a_omgL += g_omgL;
      a_Va += gd_tot * (-k);
    }
    block_add(a_ne, row + g, red);
    block_add(a_vTe, row + G + g, red);
  }
  block_add(a_omgL, row + 2 * G, red);
  block_add(a_Va, row + 2 * G + 1, red);
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
__global__ void spectrum_tail_bwd_finish_kernel(const float* __restrict__ Te, const float* __restrict__ lam,
                                                const float* __restrict__ Am, const float* __restrict__ Z,
                                                const float* __restrict__ Ti, const float* __restrict__ fract,
                                                const double* __restrict__ sums, float* __restrict__ g_ne,
                                                float* __restrict__ g_Te, float* __restrict__ g_lam,
                                                float* __restrict__ g_Va, float* __restrict__ g_ud,
                                                float* __restrict__ g_Z, float* __restrict__ g_Ti,
                                                float* __restrict__ g_fract, int B, int G, int S) {
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
  for (int s = 0; s < S; ++s) zbar += static_cast<double>(Z[b * S + s]) * static_cast<double>(fract[b * S + s]);
  double gi[kMaxSpecies];  // g_icf icf
  double g_zbar = 0.0;
  for (int s = 0; s < S; ++s) {
    const double z = Z[b * S + s], fr = fract[b * S + s];
    const double vti = sqrt(Ti[b * S + s] / (Am[b * S + s] * kMp));
    gi[s] = a_icf[s] * (fr * (z * z) / zbar / vti);
    g_zbar += (0.5 * a_kld[s] - gi[s]) / zbar;
  }
  for (int s = 0; s < S; ++s) {
    const double z = Z[b * S + s], fr = fract[b * S + s];
    const double mi = Am[b * S + s] * kMp;
    const double vti = sqrt(Ti[b * S + s] / mi);
    g_Ti[b * S + s] = static_cast<float>(((a_ti[s] - gi[s]) / vti) / (2.0 * vti * mi));
    g_Z[b * S + s] = static_cast<float>((2.0 * gi[s] - a_kld[s]) / z + g_zbar * fr);
    g_fract[b * S + s] = static_cast<float>((gi[s] - 0.5 * a_kld[s]) / fr + g_zbar * z);
  }
}

}  // namespace

// sums [B, 2 G + 2 + 3 S] float64 must arrive zeroed; every output is written
// in full.
extern "C" int spectrum_tail_bwd(const void* lf, const void* chi, const void* ne, const void* Te, const void* lam,
                                 const void* Va, const void* ud, const void* A, const void* Z, const void* Ti,
                                 const void* fract, const void* cos_sa, const void* weight, const void* omgs,
                                 const void* gauss, const void* gout, void* g_lf, void* g_chi, void* g_ne,
                                 void* g_Te, void* g_lam, void* g_Va, void* g_ud, void* g_Z, void* g_Ti,
                                 void* g_fract, void* sums, int B, int G, int L, int NA, int S, void* stream) {
  if (S < 1 || S > kMaxSpecies) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kOwned - 1) / kOwned, B);
  spectrum_tail_bwd_kernel<<<grid, kThreads, 0, st>>>(f(lf), f(chi), f(ne), f(Te), f(lam), f(Va), f(ud), f(A), f(Z),
                                                      f(Ti), f(fract), f(cos_sa), f(weight), f(omgs), f(gauss), f(gout),
                                                      m(g_lf), m(g_chi), static_cast<double*>(sums), G, L, NA, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spectrum_tail_bwd_finish_kernel<<<(B + 127) / 128, 128, 0, st>>>(
      f(Te), f(lam), f(A), f(Z), f(Ti), f(fract), static_cast<const double*>(sums), m(g_ne), m(g_Te), m(g_lam),
      m(g_Va), m(g_ud), m(g_Z), m(g_Ti), m(g_fract), B, G, S);
  return static_cast<int>(cudaGetLastError());
}
