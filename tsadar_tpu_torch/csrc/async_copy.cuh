// Asynchronous device -> shared memory copies (cp.async), shared by the kernels that stage tiles.

#pragma once

#include <cuda_runtime.h>

namespace {

// One float from device to shared memory without a register, or 0 when !valid (src is then not read).
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  if (!valid) {
    *dst = 0.0f;
    return;
  }
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Wait for every copy this thread issued (a __syncthreads must follow before others read them).
__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

}  // namespace
