// The CUDA surface the port's kernels use, emulated on the CPU for tests/test_torch_kernels_emulated.py:
// one std::thread per CUDA thread, the blocks of a launch one after another, std::barrier for
// __syncthreads and for the warp collectives (shuffles, ballots), and atomics through std::atomic_ref.
// Device maths is the host's (expf, sqrtf, an exact division for __fdividef), so results agree with the
// card's to float32 rounding, not bit for bit.  A thread that returns counts as arrived at every later
// barrier, as an exited thread does on the card.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }

namespace emu {

struct Block {
  std::vector<char> dynamic_smem;       // extern __shared__
  std::vector<char> static_smem;        // one __shared__ array a kernel
  std::unique_ptr<std::barrier<>> bar;  // __syncthreads
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<long long> warp_slot;  // 32 a warp: the lanes' values of a collective
};

inline thread_local dim3 thread_idx, block_idx, block_dim, grid_dim;
inline thread_local Block* block;
inline int last_error = 0;
inline std::atomic<long long> atomics{0};

inline int warp() { return static_cast<int>(thread_idx.x) / 32; }
inline int lane() { return static_cast<int>(thread_idx.x) & 31; }

// Every lane of the warp publishes v, then reads lane src's.
template <class T>
inline T exchange(T v, int src) {
  long long* slot = &block->warp_slot[warp() * 32];
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  slot[lane()] = bits;
  block->warp_bar[warp()]->arrive_and_wait();
  const long long got = slot[src];
  block->warp_bar[warp()]->arrive_and_wait();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}

inline unsigned ballot(bool p) {
  long long* slot = &block->warp_slot[warp() * 32];
  slot[lane()] = p;
  block->warp_bar[warp()]->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (slot[i] ? 1u : 0u) << i;
  block->warp_bar[warp()]->arrive_and_wait();
  return m;
}

template <class K, class... A>
void launch(dim3 grid, dim3 threads, size_t smem, cudaStream_t, K kernel, A... args) {
  const int n = static_cast<int>(threads.x * threads.y * threads.z);
  if (n > 1024 || threads.y != 1 || threads.z != 1 || smem > 227 * 1024) {
    last_error = cudaErrorInvalidConfiguration;
    return;
  }
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block b;
      b.dynamic_smem.assign(smem + 16, 0x7f);  // unwritten shared floats read as ~3.4e38
      b.static_smem.assign(4096, 0x7f);
      b.bar = std::make_unique<std::barrier<>>(n);
      for (int w = 0; w < (n + 31) / 32; ++w) b.warp_bar.push_back(std::make_unique<std::barrier<>>(std::min(32, n - 32 * w)));
      b.warp_slot.assign(((n + 31) / 32) * 32, 0);
      std::vector<std::thread> ts;
      for (int t = 0; t < n; ++t)
        ts.emplace_back([&, t] {
          thread_idx = dim3(t, 0, 0);
          block_idx = dim3(bx, by, 0);
          block_dim = threads;
          grid_dim = grid;
          block = &b;
          kernel(args...);
          b.bar->arrive_and_drop();
          b.warp_bar[t / 32]->arrive_and_drop();
        });
      for (auto& th : ts) th.join();
    }
}

}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
#define blockDim emu::block_dim
#define gridDim emu::grid_dim

inline cudaError_t cudaGetLastError() {
  const int e = emu::last_error;
  emu::last_error = 0;
  return e;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline void __syncthreads() { emu::block->bar->arrive_and_wait(); }
inline bool __any_sync(unsigned, bool p) { return emu::ballot(p) != 0; }
inline unsigned __ballot_sync(unsigned, bool p) { return emu::ballot(p); }
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d) {
  return emu::exchange(v, emu::lane() >= d ? emu::lane() - d : emu::lane());
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, int d) {
  return emu::exchange(v, emu::lane() + d < 32 ? emu::lane() + d : emu::lane());
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline float __fdividef(float a, float b) { return a / b; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float atomicAdd(float* p, float v) {
  ++emu::atomics;
  return std::atomic_ref<float>(*p).fetch_add(v);
}
inline double atomicAdd(double* p, double v) {
  ++emu::atomics;
  return std::atomic_ref<double>(*p).fetch_add(v);
}
inline float2 atomicAdd(float2* p, float2 v) {  // one vector atomic on the card: counted once
  ++emu::atomics;
  float* f = reinterpret_cast<float*>(p);
  return {std::atomic_ref<float>(f[0]).fetch_add(v.x), std::atomic_ref<float>(f[1]).fetch_add(v.y)};
}

// The atomics made since the last call (float and vector ones alike).
extern "C" long long emu_atomics_taken() { return emu::atomics.exchange(0); }
