// Shared helpers for the port's hand-written Hopper kernels.
//
// Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// into one shared library with a plain C interface, loaded with ctypes.
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launches.
//
// Numerics: float32 FFMA throughout.  No TF32, no --use_fast_math: the
// interior-point sweep relies on IEEE inf/NaN propagation and on
// correctly rounded division and square root.  Reductions use a fixed
// order (warp shuffles in a tree, partial sums combined in index order), so
// a result does not change from run to run.
#pragma once

#include <cuda_runtime.h>

#define BGGT_API extern "C" __attribute__((visibility("default")))

namespace bggt {

// jnp.minimum / jnp.maximum semantics: a NaN operand wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
// jnp.clip semantics: NaN passes through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace bggt
