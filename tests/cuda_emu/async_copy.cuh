// The CPU emulation's stand-in for tsadar_tpu_torch/csrc/async_copy.cuh: the copies are made at once.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) { *dst = valid ? *src : 0.0f; }
__device__ __forceinline__ void copies_done() {}

}  // namespace
