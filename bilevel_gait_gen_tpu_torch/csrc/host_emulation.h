// Host emulation of the CUDA subset the port's kernels use, so that the
// kernel sources can be compiled with a C++20 host compiler and run on CPU
// tensors where there is no GPU and no nvcc (tests/test_torch_kernels.py).
//
// One std::thread per CUDA thread; the blocks of a launch run one after
// another, so `__shared__` arrays become function statics.  __syncthreads
// is a std::barrier over the block, __syncwarp and the shuffles one over
// the warp; dynamic shared memory is poisoned with NaN before each block.
// The test rewrites `kernel<<<grid, block, smem, stream>>>(args)` into
// `emu_launch(kernel, grid, block, smem, stream, args)` and
// `extern __shared__ __align__(16) float smem[];` into
// `float* smem = emu_dyn;` before it compiles.  cp.async copies are
// synchronous here (cp_async_commit and cp_async_wait do nothing), so a
// missing wait shows only on the card; a missing barrier before a stage is
// overwritten does show.  Not a model of timing or of the memory model: a check of the
// arithmetic, indexing and barrier structure only.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define BGGT_HOST_EMULATION 1

using std::isfinite;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host emulation"; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline std::vector<std::vector<float>> emu_shuffle;
inline float* emu_dyn = nullptr;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_shuffle[w][l] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  const float r = emu_shuffle[w][l ^ lane_mask];
  emu_warp_barriers[w]->arrive_and_wait();
  return r;
}
// separately rounded product and difference (no contraction into an FMA)
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}

inline void cp_async_16(float* smem_dst, const float* gmem_src) {
  std::memcpy(smem_dst, gmem_src, 16);
}
inline void cp_async_commit() {}
template <int kPending>
inline void cp_async_wait() {}

template <class... KA, class... A>
void emu_launch(void (*kernel)(KA...), dim3 grid, dim3 block, size_t smem,
                cudaStream_t, A... args) {
  const int nt = block.x * block.y * block.z;
  std::vector<float4> dyn4(smem / 16 + 1);
  float* dyn = &dyn4[0].x;
  const size_t dyn_n = 4 * dyn4.size();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(nt);
        emu_block_barrier = &bar;
        emu_warp_barriers.clear();
        emu_shuffle.assign(nt / 32, std::vector<float>(32));
        for (int w = 0; w < nt / 32; ++w)
          emu_warp_barriers.emplace_back(new std::barrier<>(32));
        std::fill(dyn, dyn + dyn_n, __int_as_float(0x7fc00000));
        emu_dyn = dyn;
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
