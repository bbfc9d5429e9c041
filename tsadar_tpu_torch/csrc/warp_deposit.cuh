// Warp-aggregated deposits into a shared-memory accumulator, shared by the lookups' table cotangents
// (K2 and K10's cotangent in lin_lookup.cu, K4 in cubic_lookup.cu).
//
// The 32 lanes of a warp hold 32 consecutive queries of one row.  Lane l adds v[t] to
// acc[key + kFirst + t] for each of its T taps.  Real queries crowd: those beyond a table's ends
// clamp onto its end cell, and neighbouring queries often share a cell, so 32 lanes adding to one
// shared address serialise.  Here a run of neighbouring lanes with the same key is summed first,
// by a segmented scan over the lanes in a fixed tree order, and only the run's last lane adds:
// a warp whose 32 queries fall into one cell makes one shared atomic per tap instead of 32.  A
// warp in which no two neighbours share a cell adds lane by lane, with no scan, and a warp whose
// values are all zero adds nothing.  Exact zeros are never added (the accumulator starts at +0.0
// and x + 0 == x, so the sum is unchanged), nor taps outside [0, width).  A float atomicAdd on
// shared memory is a compare-and-swap loop on this card (ATOMS.CAST.SPIN in the SASS), so lanes
// that add to one address retry in turn: that is what the runs and the zero skip save.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Every lane of the warp must call this together; a lane without a query passes key -1 and zeros.
template <int T, int kFirst>
__device__ __forceinline__ void warp_deposit(float* acc, int width, int key, float (&v)[T]) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  bool any = false;
#pragma unroll
  for (int t = 0; t < T; ++t) any |= v[t] != 0.0f;
  if (!__any_sync(kFullMask, any)) return;
  const int prev = __shfl_up_sync(kFullMask, key, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || key != prev);
  bool adds = true;
  if (heads != kFullMask) {
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
    adds = lane == 31 || ((heads >> (lane + 1)) & 1u);
  }
  if (!adds) return;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = key + kFirst + t;
    if (v[t] != 0.0f && i >= 0 && i < width) atomicAdd(&acc[i], v[t]);
  }
}

}  // namespace
