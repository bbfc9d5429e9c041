// The whole 1V spectrum tail: from the two lookups (log f_e and chi_R at the
// electron phase velocities) to the angle-weighted, gradient-averaged
// spectrum of each lineout.
//
// Replaces tsadar_tpu/ops/spectrum_kernel.py::spectrum_tail_pallas, whose
// oracle is tsadar_tpu/core/physics/form_factor.py::_reduced_tail; the plain
// twin here is tsadar_tpu_torch/core/physics/form_factor.py::_reduced_tail.
// Per point: scattering kinematics, the ion susceptibility with Z' from the
// float32 Dawson branch (15-term centered Rybicki with h = 0.36 on |x| <= 6;
// beyond it 1 - 2 x D is the 6-term asymptotic series' own form, as in the
// cotangent kernel, without the cancellation), the spectral-difference
// electron Landau term, the S(k, omega) assembly, and the weighted sum over
// angles and mean over gradient points.
//
// Bound on this card: it reads lf and chi once (8 B per point) and writes one
// float per (lineout, wavelength).  Main path [128, 1, 5120, 10]: ~55 MB,
// ~16 us at 3.35 TB/s.  Counted as operations (each transcendental and each
// division as one) ~230 per point at one species, ~22 us at the 67 TFLOP/s
// f32 peak.  What it really waits on is instruction issue: an IEEE float32
// division or square root is a sequence of ~8-10 instructions and expf ~6-8
// (PERF.md gives the issue estimate from the SASS).
//
// What the first design lost (H100 80GB HBM3, 700 W; chip_smoke.py): 0.217 ms
// on seeded main-path operands and 0.222 ms inside the real-data fit step,
// ~10x the operation bound.  ptxas: 65 registers and a 192-byte stack: the
// per-species arrays ([kMaxSpecies] each, indexed by the run-time S) lived in
// local memory.  The angle loop was outermost, so the kinematics that do not
// depend on the angle (k_s, k_L, omega_pe, vTe, per species n_i and
// omega_pi: 5 + 2S square roots, ~8 + 3S divisions) were recomputed for every
// angle; each thread recomputed its right neighbour's k, xi_e and f_e for the
// Landau term's difference; and a warp read lf and chi at stride A (10 cache
// lines for 128 useful bytes).
//
// This design (one thread per (lineout, wavelength), kThreads wavelengths a
// block, every sum in registers in a fixed order, no atomics, no second pass):
// * The kernel is a template on the number of species S (1..kMaxSpecies,
//   dispatched in the C entry point): every per-species array is in
//   registers.  The Rybicki weights stay in global memory (read only on the
//   rare |x| <= 6 branch of the ions' Dawson function), not in 15 registers.
// * The gradient point is the outer loop.  What depends on it and not on the
//   angle is computed once per (lineout, gradient point, wavelength): omega_pe,
//   k_L, vTe and its reciprocal, (omega_pe / vTe)^2 = k^2 / klde^2 and per
//   species (omega_pi / vTi)^2 = k^2 / kldi^2; 1/(sqrt2 vTi) and the species'
//   weights once per lineout.
// * Per gradient point and chunk of at most kMaxChunk angles the block stages
//   its slab -- wavelengths [first, first + kThreads] x the chunk's angles of
//   lf (one right halo), [first, first + kThreads) of chi; with A <= kMaxChunk
//   one chunk, contiguous in memory -- into shared memory with coalesced
//   asynchronous copies (cp.async), and a pre-pass computes at every slab
//   point, once, f_e = exp(lf), k and xi_e.  A thread reads its own point and
//   its right neighbour's from there: the neighbour is no longer recomputed,
//   and both sides of the difference xi_e[l+1] - xi_e[l] come from one
//   expression.  The last wavelength has no neighbour and gets df = 0.  The
//   chunks bound the shared memory at ~25 KB a block whatever A is.
// * 1/k and 1/E2 are hardware reciprocals (__fdividef: an ulp or two, no IEEE
//   division sequence), multiplied where the formula divided; the Landau
//   difference and the asymptotic series keep their IEEE divisions.
// * __launch_bounds__ keeps 8 blocks an SM resident with one species (the
//   main path), 4 with more, whose per-species registers would spill under the
//   tighter cap.

#include "async_copy.cuh"
#include "spectrum_tail_common.cuh"

namespace {

constexpr int kThreads = 128;        // wavelengths a block owns, one a thread
constexpr int kSlab = kThreads + 1;  // wavelengths of the staged slab: the owned ones and one right of them
constexpr int kMaxChunk = 12;        // angles staged at once

// __launch_bounds__' minimum of resident blocks: registers capped at 65536 / (128 x 8) with one species
// (the main path); more species keep more in registers and would spill under that cap
__host__ __device__ constexpr int min_blocks(int S) { return S == 1 ? 8 : 4; }

// Shared floats for chunks of NC angles: per angle, f_e (staged as lf), k and xi_e on the slab and chi per
// thread; and k_s per slab wavelength.
__host__ __device__ constexpr int smem_floats(int NC) { return (3 * kSlab + kThreads) * NC + kSlab; }
static_assert(smem_floats(kMaxChunk) * sizeof(float) <= 48 * 1024, "a block's shared memory must need no opt-in");
static_assert(8 * (smem_floats(kMaxChunk) * sizeof(float) + 1024) <= 228 * 1024, "8 blocks (1 KB each reserved) must fit an SM");

// 1 - 2 x D(x).  Above |x| = 6, where D = S / (2 x) with S = sum_n (2n-1)!! s^n, s = 1 / (2 x^2), it is
// the series' own form 1 - S, which does not cancel at the ions' large phase velocities.
__device__ __forceinline__ float one_minus_2xd(float x, const float* __restrict__ gauss, float sqrt_pi) {
  if (fabsf(x) > 6.0f) {
    const float s = 1.0f / (2.0f * x * x);
    return -s * (1.0f + s * (3.0f + s * (15.0f + s * (105.0f + s * (945.0f + s * 10395.0f)))));
  }
  return 1.0f - 2.0f * x * dawsn_f32(x, gauss, sqrt_pi);
}

template <int S>
__global__ void __launch_bounds__(kThreads, min_blocks(S)) spectrum_tail_kernel(
    const float* __restrict__ lf, const float* __restrict__ chi, const float* __restrict__ ne,
    const float* __restrict__ Te, const float* __restrict__ lam, const float* __restrict__ Va,
    const float* __restrict__ ud, const float* __restrict__ Am, const float* __restrict__ Z,
    const float* __restrict__ Ti, const float* __restrict__ fract, const float* __restrict__ cos_sa,
    const float* __restrict__ weight, const float* __restrict__ omgs, const float* __restrict__ gauss,
    float* __restrict__ out, int G, int L, int NA, int NC) {
  // laid out for chunks of NC angles; a chunk of nc <= NC angles uses [rows][nc] of each
  extern __shared__ float smem[];
  float* fe_s = smem;                  // [kSlab][nc]: lf as staged, then f_e
  float* k_s = fe_s + kSlab * NC;      // [kSlab][nc]
  float* xie_s = k_s + kSlab * NC;     // [kSlab][nc]
  float* chi_s = xie_s + kSlab * NC;   // [kThreads][nc]
  float* ks_s = chi_s + kThreads * NC; // [kSlab]

  const int b = blockIdx.y;
  const int tid = static_cast<int>(threadIdx.x);
  const int first = static_cast<int>(blockIdx.x) * kThreads;  // the block's first wavelength
  const int l = min(first + tid, L - 1);  // a thread past the end computes the last point and discards it
  const int ic = l - first;               // its slab row
  const bool has_next = l + 1 < L;

  const Consts K = make_consts();
  const float omgL = K.omgl_num / lam[b];
  const float two_over_omgL = 2.0f / omgL;
  const float va = Va[b];
  const float udb = ud[b];
  const float om = omgs[l];
  const float inv_sqrt_2pi = static_cast<float>(1.0 / sqrt(2.0 * kPi));

  // per species: icf = fract Z^2 / (Zbar vTi), 1 / (sqrt2 vTi), and (omega_pi / vTi)^2 / ne
  float icf[S], inv_s2vti[S], cpi[S];
  float zbar = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) zbar += Z[b * S + s] * fract[b * S + s];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float z = Z[b * S + s], fr = fract[b * S + s], mi = Am[b * S + s] * K.mp;
    const float vti = sqrtf(Ti[b * S + s] / mi);
    icf[s] = fr * (z * z) / zbar / vti;
    inv_s2vti[s] = 1.0f / (K.sqrt2 * vti);
    const float r = K.pfc * z / vti;
    cpi[s] = r * r * (fr * K.me / (zbar * mi));
  }

  float total = 0.0f;
  for (int g = 0; g < G; ++g) {
    // ---- per (lineout, gradient point): everything the angle loop does not change
    const float ne_g = ne[b * G + g];
    const float omgpe = K.pfc * sqrtf(ne_g);
    const float kL = sqrtf(omgL * omgL - omgpe * omgpe) / K.c;
    const float vTe = sqrtf(Te[b * G + g] / K.me);
    const float inv_vTe = 1.0f / vTe;
    const float ud_vTe = udb / vTe;
    const float pe_vTe = omgpe * inv_vTe;
    const float e_k2 = pe_vTe * pe_vTe;  // 1 / klde^2 = e_k2 / k^2
    const size_t row0 = static_cast<size_t>(b * G + g) * L * NA;  // this (lineout, gradient point)'s first entry
    float acc = 0.0f;  // sum over angles of weight S(k, omega) (1 + 2 omega_dop / omega_L)

    for (int a0 = 0; a0 < NA; a0 += NC) {
      const int nc = min(NC, NA - a0);  // this chunk's angles: a0 .. a0 + nc - 1

      // ---- the slab: lf and chi in, coalesced; then f_e, k and xi_e at every slab point
      __syncthreads();  // the previous chunk's slab is consumed
      SlabWalk<kThreads> w(tid, nc);
      for (int e = tid; e < kSlab * nc; e += kThreads, w.next()) {
        const int li = first + w.row;
        const bool ok = li < L;
        const size_t src = ok ? row0 + static_cast<size_t>(li) * NA + a0 + w.col : 0;
        copy_async(fe_s + e, lf + src, ok);
        if (e < kThreads * nc) copy_async(chi_s + e, chi + src, ok);
      }
      for (int i = tid; i < kSlab; i += kThreads) {
        const int li = min(first + i, L - 1);
        ks_s[i] = sqrtf(omgs[li] * omgs[li] - omgpe * omgpe) / K.c;
      }
      copies_done();
      __syncthreads();
      w = SlabWalk<kThreads>(tid, nc);
      for (int e = tid; e < kSlab * nc; e += kThreads, w.next()) {  // entry by entry: every thread takes ~nc of them
        const int i = w.row, li = first + i;
        if (li >= L) continue;
        const float ks_i = ks_s[i];
        const float cth = cos_sa[a0 + w.col];
        const float k = sqrtf(ks_i * ks_i + kL * kL - 2.0f * ks_i * kL * cth);
        fe_s[e] = expf(fe_s[e]);
        k_s[e] = k;
        xie_s[e] = ((omgs[li] - omgL) - k * va) / (k * vTe) - ud_vTe;
      }
      __syncthreads();

      for (int a = 0; a < nc; ++a) {
        const int e = ic * nc + a;
        const float k = k_s[e];
        const float fe = fe_s[e];
        const float df = has_next ? (fe_s[e + nc] - fe) / (xie_s[e + nc] - xie_s[e]) : 0.0f;
        const float inv_k = __fdividef(1.0f, k);
        const float inv_k2 = inv_k * inv_k;
        const float omgdop = (om - omgL) - k * va;
        const float iklde2 = e_k2 * inv_k2;
        const float ceR = -iklde2 * chi_s[e];
        const float ceI = -K.pi * iklde2 * df;
        const float od_k = omgdop * inv_k;
        const float ne_k2 = ne_g * inv_k2;

        float ciR = 0.0f, ciI = 0.0f, SA = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float xii = od_k * inv_s2vti[s];
          const float ex2 = expf(-(xii * xii));
          const float ik2 = cpi[s] * ne_k2;  // 1 / kldi^2
          ciR += ik2 * one_minus_2xd(xii, gauss, K.sqrt_pi);  // -ik2 / 2 Re Z', Re Z' = -2 (1 - 2 x D)
          ciI += ik2 * (K.sqrt_pi * xii * ex2);               // -ik2 / 2 Im Z', Im Z' = -2 sqrt(pi) x e^{-x^2}
          SA += icf[s] * (ex2 * inv_sqrt_2pi);
        }

        const float epsR = 1.0f + ceR + ciR;
        const float epsI = ceI + ciI;
        const float E2 = epsR * epsR + epsI * epsI;
        const float AE2 = ceR * ceR + ceI * ceI;
        const float BI2 = (1.0f + ciR) * (1.0f + ciR) + ciI * ciI;
        const float SKW = (AE2 * SA + BI2 * fe * inv_vTe) * (inv_k * __fdividef(1.0f, E2));
        acc += SKW * (1.0f + omgdop * two_over_omgL) * weight[a0 + a];
      }
    }
    total += acc * ne_g;
  }
  // 2 pi c / lams^2 with lams = 2 pi c / om, re^2, and the mean over gradient points
  if (first + tid < L) out[static_cast<size_t>(b) * L + l] = total * (om * om / (2.0f * K.pi * K.c) * K.re2 / static_cast<float>(G));
}

struct Args {
  const float *lf, *chi, *ne, *Te, *lam, *Va, *ud, *A, *Z, *Ti, *fract, *cos_sa, *weight, *omgs, *gauss;
  float* out;
  int B, G, L, NA;
  cudaStream_t stream;
};

template <int S>
int launch(const Args& x) {
  // the angles in chunks of at most kMaxChunk, as even as they go
  const int chunks = x.NA > kMaxChunk ? (x.NA + kMaxChunk - 1) / kMaxChunk : 1;
  const int NC = (x.NA + chunks - 1) / chunks;
  const size_t smem = static_cast<size_t>(smem_floats(NC)) * sizeof(float);
  const dim3 grid((x.L + kThreads - 1) / kThreads, x.B);
  spectrum_tail_kernel<S><<<grid, kThreads, smem, x.stream>>>(x.lf, x.chi, x.ne, x.Te, x.lam, x.Va, x.ud, x.A, x.Z,
                                                              x.Ti, x.fract, x.cos_sa, x.weight, x.omgs, x.gauss,
                                                              x.out, x.G, x.L, x.NA, NC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spectrum_tail_fwd(const void* lf, const void* chi, const void* ne, const void* Te, const void* lam,
                                 const void* Va, const void* ud, const void* A, const void* Z, const void* Ti,
                                 const void* fract, const void* cos_sa, const void* weight, const void* omgs,
                                 const void* gauss, void* out, int B, int G, int L, int NA, int S, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Args x{f(lf), f(chi), f(ne), f(Te), f(lam), f(Va), f(ud), f(A), f(Z), f(Ti), f(fract), f(cos_sa),
               f(weight), f(omgs), f(gauss), static_cast<float*>(out), B, G, L, NA,
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
