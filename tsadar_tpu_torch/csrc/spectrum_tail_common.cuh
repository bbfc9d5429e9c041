// Device functions shared by the spectrum-tail kernels (spectrum_tail.cu, the
// forward, and spectrum_tail_bwd.cu, its cotangents): the physical constants
// in float32, rounded from the same float64 expressions as
// core/physics/constants.py, the float32 Dawson branch of
// core/physics/zprime.py, and the walk over a staged [wavelength][angle] slab.

#pragma once

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

// (row, column) of the entries e = tid, tid + kStride, ... of a [rows][nc] slab, stepped without a division.
template <int kStride>
struct SlabWalk {
  int row, col, drow, dcol, nc;
  __device__ SlabWalk(int tid, int nc) : row(tid / nc), col(tid % nc), drow(kStride / nc), dcol(kStride % nc), nc(nc) {}
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= nc) {
      col -= nc;
      ++row;
    }
  }
};

}  // namespace
