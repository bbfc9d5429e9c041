// Warp-aggregated deposits, shared by the lookups' table cotangents (K2 and K10's cotangent in
// lin_lookup.cu, K4 in cubic_lookup.cu, into a shared-memory accumulator) and by the chi tables'
// cotangent (K8 in chi_bilinear.cu, straight into its output in device memory).
//
// The 32 lanes of a warp hold 32 consecutive queries.  Each lane has T values to add at T targets
// that follow from its key alone (a cell of the table): two lanes with one key add to the same T
// targets.  Real queries crowd: those beyond a table's ends clamp onto its end cell, and
// neighbouring queries often share a cell, so 32 lanes adding to one address serialise.  Here a run
// of neighbouring lanes with the same key is summed first, by a segmented scan over the lanes in a
// fixed tree order, and only the run's last lane adds: a warp whose 32 queries fall into one cell
// makes one atomic per target instead of 32.  A warp in which no two neighbours share a cell adds
// lane by lane, with no scan, and a warp whose values are all zero adds nothing.  Exact zeros are
// never added (the accumulator starts at +0.0 and x + 0 == x, so the sum is unchanged).  A float
// atomicAdd on shared memory is a compare-and-swap loop on this card (ATOMS.CAST.SPIN in the SASS),
// and one on device memory is carried out in L2, one address at a time: lanes that add to one
// address wait in turn either way, and that is what the runs and the zero skip save.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Sums every run of neighbouring lanes with one key into the run's last lane and returns true on the lanes
// that then add their v (every lane when no two neighbours share a key; none when every v is zero).  Every
// lane of the warp must call this together; a lane without a query passes key -1 and zeros.
template <int T>
__device__ __forceinline__ bool warp_runs(int key, float (&v)[T]) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  bool any = false;
#pragma unroll
  for (int t = 0; t < T; ++t) any |= v[t] != 0.0f;
  if (!__any_sync(kFullMask, any)) return false;
  const int prev = __shfl_up_sync(kFullMask, key, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || key != prev);
  if (heads == kFullMask) return true;
  // the run of lane l starts at the highest head at or below l; inclusive scan within runs
  const int start = 31 - __clz(heads & (kFullMask >> (31 - lane)));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float u = __shfl_up_sync(kFullMask, v[t], d);
      if (lane - d >= start) v[t] += u;
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// Adds v unless it is an exact zero.
__device__ __forceinline__ void add_nonzero(float* dst, float v) {
  if (v != 0.0f) atomicAdd(dst, v);
}

// Lane l adds v[t] to acc[key + kFirst + t] for each of its T taps, taps outside [0, width) not at all.
template <int T, int kFirst>
__device__ __forceinline__ void warp_deposit(float* acc, int width, int key, float (&v)[T]) {
  if (!warp_runs(key, v)) return;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = key + kFirst + t;
    if (i >= 0 && i < width) add_nonzero(&acc[i], v[t]);
  }
}

}  // namespace
