// The whole 1V spectrum tail: from the two lookups (log f_e and chi_R at the
// electron phase velocities) to the angle-weighted, gradient-averaged
// spectrum of each lineout.
//
// Replaces tsadar_tpu/ops/spectrum_kernel.py::spectrum_tail_pallas, whose
// oracle is tsadar_tpu/core/physics/form_factor.py::_reduced_tail; the plain
// twin here is tsadar_tpu_torch/core/physics/form_factor.py::_reduced_tail,
// and this kernel follows its expressions in the same order.  Per point:
// scattering kinematics, the ion susceptibility with Z' from the float32
// Dawson branch (15-term centered Rybicki with h = 0.36 on |x| <= 6, the
// 6-term asymptotic series beyond), the spectral-difference electron Landau
// term, the S(k, omega) assembly, and the weighted sum over angles and mean
// over gradient points.
//
// Bound on this card: it reads lf and chi once (8 B per point) and writes one
// float per (lineout, wavelength).  Main path [128, 1, 5120, 10]: ~55 MB,
// ~16 us at 3.35 TB/s.  The arithmetic is ~20 transcendental and ~150 other
// f32 operations per point and species (~1-2 GFLOP): at the 67 TFLOP/s f32
// peak, within a factor ~2 of the memory bound, so this kernel sits near the
// ridge and keeps every intermediate in registers.
//
// Design: one thread owns one (lineout, wavelength) output and loops over
// angles, gradient points and species, summing in registers in a fixed
// order -- no atomics, no shared memory, no second pass.  The Landau term's
// spectral difference needs xi_e and f_e at l+1: the thread recomputes the
// neighbour's kinematics and reads lf at l+1; the last wavelength gets 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxSpecies = 8;
constexpr int kNJ = 15;  // Rybicki terms j = -7..7
constexpr double kC = 2.99792458e10;
constexpr double kMe = 510.9896 / (kC * kC);
constexpr double kMp = kMe * 1836.1;
constexpr double kRe = 2.8179e-13;
constexpr double kEsq = kMe * (kC * kC) * kRe;  // same rounding as constants.py's ME_KEV * C**2 * RE_CM
constexpr double kPi = 3.141592653589793;
constexpr double kH = 0.36;

struct Consts {
  float c, me, mp, re2, pfc, omgl_num, sqrt2, sqrt_pi, sqrt_2pi, pi;
};

__device__ __forceinline__ Consts make_consts() {
  Consts k;
  k.c = static_cast<float>(kC);
  k.me = static_cast<float>(kMe);
  k.mp = static_cast<float>(kMp);
  k.re2 = static_cast<float>(kRe * kRe);
  k.pfc = static_cast<float>(sqrt(4.0 * kPi * kEsq / kMe));
  k.omgl_num = static_cast<float>(2.0 * kPi * 1.0e7 * kC);
  k.sqrt2 = static_cast<float>(sqrt(2.0));
  k.sqrt_pi = static_cast<float>(sqrt(kPi));
  k.sqrt_2pi = static_cast<float>(sqrt(2.0 * kPi));
  k.pi = static_cast<float>(kPi);
  return k;
}

__device__ __forceinline__ float dawsn_f32(float x, const float* __restrict__ gauss, float sqrt_pi) {
  if (fabsf(x) > 6.0f) {
    const float s = 1.0f / (2.0f * x * x);
    const float series = 1.0f + s * (1.0f + s * (3.0f + s * (15.0f + s * (105.0f + s * (945.0f + s * 10395.0f)))));
    return series / (2.0f * x);
  }
  const float n0 = 2.0f * floorf(x / static_cast<float>(2.0 * kH)) + 1.0f;
  const float u = x - n0 * static_cast<float>(kH);
  const float a = static_cast<float>(4.0 * kH) * u;
  float series = 0.0f;
#pragma unroll
  for (int jj = 0; jj < kNJ; ++jj) {
    const float j = static_cast<float>(jj - kNJ / 2);
    series += gauss[jj] * expf(a * j) / (n0 + 2.0f * j);
  }
  return expf(-(u * u)) * series / sqrt_pi;
}

__global__ void spectrum_tail_kernel(const float* __restrict__ lf, const float* __restrict__ chi,
                                     const float* __restrict__ ne, const float* __restrict__ Te,
                                     const float* __restrict__ lam, const float* __restrict__ Va,
                                     const float* __restrict__ ud, const float* __restrict__ Am,
                                     const float* __restrict__ Z, const float* __restrict__ Ti,
                                     const float* __restrict__ fract, const float* __restrict__ cos_sa,
                                     const float* __restrict__ weight, const float* __restrict__ omgs,
                                     const float* __restrict__ gauss_in, float* __restrict__ out, int G, int L,
                                     int NA, int S) {
  const int b = blockIdx.y;
  const int l = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (l >= L) return;
  const Consts K = make_consts();
  float gauss[kNJ];
#pragma unroll
  for (int jj = 0; jj < kNJ; ++jj) gauss[jj] = gauss_in[jj];

  const bool has_next = l + 1 < L;
  const float omgL = K.omgl_num / lam[b];
  const float va = Va[b];
  const float udb = ud[b];
  const float om = omgs[l];
  const float om_n = has_next ? omgs[l + 1] : om;
  const float lams = static_cast<float>(2.0 * kPi * kC) / om;

  // per-species constants of this lineout
  float zs[kMaxSpecies], frs[kMaxSpecies], mis[kMaxSpecies], vti[kMaxSpecies], icf[kMaxSpecies];
  float zbar = 0.0f;
  for (int s = 0; s < S; ++s) {
    zs[s] = Z[b * S + s];
    frs[s] = fract[b * S + s];
    zbar += zs[s] * frs[s];
  }
  for (int s = 0; s < S; ++s) {
    mis[s] = Am[b * S + s] * K.mp;
    vti[s] = sqrtf(Ti[b * S + s] / mis[s]);
    icf[s] = frs[s] * (zs[s] * zs[s]) / zbar / vti[s];
  }

  float total = 0.0f;
  for (int a = 0; a < NA; ++a) {
    const float cth = cos_sa[a];
    float gsum = 0.0f;
    for (int g = 0; g < G; ++g) {
      const float ne_g = ne[b * G + g];
      const float omgpe = K.pfc * sqrtf(ne_g);
      const float ks = sqrtf(om * om - omgpe * omgpe) / K.c;
      const float ks_n = sqrtf(om_n * om_n - omgpe * omgpe) / K.c;
      const float kL = sqrtf(omgL * omgL - omgpe * omgpe) / K.c;
      const float vTe = sqrtf(Te[b * G + g] / K.me);

      const float k = sqrtf(ks * ks + kL * kL - 2.0f * ks * kL * cth);
      const float omgdop = (om - omgL) - k * va;
      const float klde = (vTe / omgpe) * k;
      const float xie = omgdop / (k * vTe) - udb / vTe;

      const size_t idx = ((static_cast<size_t>(b) * G + g) * L + l) * NA + a;
      const float fe = expf(lf[idx]);
      float df = 0.0f;
      if (has_next) {
        const float k_n = sqrtf(ks_n * ks_n + kL * kL - 2.0f * ks_n * kL * cth);
        const float xie_n = ((om_n - omgL) - k_n * va) / (k_n * vTe) - udb / vTe;
        df = (expf(lf[idx + NA]) - fe) / (xie_n - xie);
      }
      const float ceR = -1.0f / (klde * klde) * chi[idx];
      const float ceI = -K.pi / (klde * klde) * df;

      float ciR = 0.0f, ciI = 0.0f;
      float ex2[kMaxSpecies];
      for (int s = 0; s < S; ++s) {
        const float ni = frs[s] * ne_g / zbar;
        const float omgpi = K.pfc * zs[s] * sqrtf(ni * K.me / mis[s]);
        const float kldi = (vti[s] / omgpi) * k;
        const float xii = (omgdop / k) / (K.sqrt2 * vti[s]);
        const float D = dawsn_f32(xii, gauss, K.sqrt_pi);
        ex2[s] = expf(-(xii * xii));
        const float ZpR = -2.0f * (1.0f - 2.0f * xii * D);
        const float ZpI = -2.0f * K.sqrt_pi * xii * ex2[s];
        ciR += -0.5f / (kldi * kldi) * ZpR;
        ciI += -0.5f / (kldi * kldi) * ZpI;
      }

      const float epsR = 1.0f + ceR + ciR;
      const float epsI = ceI + ciI;
      const float E2 = epsR * epsR + epsI * epsI;
      const float AE2 = ceR * ceR + ceI * ceI;
      const float BI2 = (1.0f + ciR) * (1.0f + ciR) + ciI * ciI;
      float skw_ion = 0.0f;
      for (int s = 0; s < S; ++s) skw_ion += 1.0f / k * (icf[s] * (AE2 * ex2[s] / K.sqrt_2pi)) / E2;
      const float skw_ele = 1.0f / k * (BI2 * fe / vTe) / E2;
      const float ps = (skw_ion + skw_ele) * (1.0f + 2.0f * omgdop / omgL) * K.re2 * ne_g;
      gsum += ps * 2.0f * K.pi * K.c / (lams * lams);
    }
    total += gsum / static_cast<float>(G) * weight[a];
  }
  out[static_cast<size_t>(b) * L + l] = total;
}

}  // namespace

extern "C" int spectrum_tail_fwd(const void* lf, const void* chi, const void* ne, const void* Te, const void* lam,
                                 const void* Va, const void* ud, const void* A, const void* Z, const void* Ti,
                                 const void* fract, const void* cos_sa, const void* weight, const void* omgs,
                                 const void* gauss, void* out, int B, int G, int L, int NA, int S, void* stream) {
  if (S < 1 || S > kMaxSpecies) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  spectrum_tail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lf), static_cast<const float*>(chi), static_cast<const float*>(ne),
      static_cast<const float*>(Te), static_cast<const float*>(lam), static_cast<const float*>(Va),
      static_cast<const float*>(ud), static_cast<const float*>(A), static_cast<const float*>(Z),
      static_cast<const float*>(Ti), static_cast<const float*>(fract), static_cast<const float*>(cos_sa),
      static_cast<const float*>(weight), static_cast<const float*>(omgs), static_cast<const float*>(gauss),
      static_cast<float*>(out), G, L, NA, S);
  return static_cast<int>(cudaGetLastError());
}
