// Shared helpers for the port's hand-written Hopper kernels.
//
// Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -Xcompiler -fPIC -c <source>        (one per source, side by side)
//   nvcc -shared -o libbggt_kernels.so <objects>
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

// 16-byte loads and stores (the address must be 16-byte aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Asynchronous 16-byte copies from global to shared memory (cp.async,
// bypassing L1), grouped by commit and awaited by group count.  The host
// emulation has synchronous versions of the same names.
#ifndef BGGT_HOST_EMULATION
__device__ __forceinline__ void cp_async_16(float* smem_dst,
                                            const float* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of the committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
#endif

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

// Lets `kernel` take all the dynamic shared memory a block of the current
// device may have (the opt-in limit less its static shared memory).  Each
// launcher calls it once, for its first launch, through a function-local
// static: no later launch makes an attribute call, so a CUDA graph capture
// sees the launches alone.
template <class K>
inline cudaError_t allow_max_dynamic_smem(K kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&fa, kernel);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)fa.sharedSizeBytes);
  return rc;
}

}  // namespace bggt
