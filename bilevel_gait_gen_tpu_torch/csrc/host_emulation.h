// Host emulation of the CUDA subset the port's kernels use, so that the
// kernel sources can be compiled with a C++20 host compiler and run on CPU
// tensors where there is no GPU and no nvcc (tests/test_torch_kernels.py).
//
// One fiber (a ucontext of the calling thread, its own stack) per CUDA
// thread, run one at a time, round-robin; the blocks of a launch run one
// after another, so `__shared__` arrays become function statics.
// __syncthreads is a barrier over the block's fibers, __syncwarp and the
// shuffles one over the warp's: a fiber yields there until the last one
// arrives.  A launch takes one core however many threads it has.  Between
// two barriers the threads run one after another, in thread order or in
// reverse by turns, so a missing barrier shows, the same way at every run,
// where a thread reads what a thread that runs after it writes (NaN from
// the poisoned shared memory, or an older value), and not where the writer
// runs first.  Dynamic shared memory is poisoned with NaN before each
// block.
// The test rewrites `kernel<<<grid, block, smem, stream>>>(args)` into
// `emu_launch(kernel, grid, block, smem, stream, args)` and
// `extern __shared__ __align__(16) float smem[];` into
// `float* smem = emu_dyn;` before it compiles.  cp.async copies are
// synchronous here (cp_async_commit and cp_async_wait do nothing), so a
// missing wait shows only on the card; a missing barrier before a stage is
// overwritten does show.  Not a model of timing or of the memory model: a check of the
// arithmetic, indexing and barrier structure only.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
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
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
struct cudaFuncAttributes {
  size_t sharedSizeBytes;
};
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 232448;
  return 0;
}
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* fa, F) {
  fa->sharedSizeBytes = 0;
  return 0;
}
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

// The running CUDA thread's indices: one fiber runs at a time, and the
// scheduler sets them before it resumes one.
inline dim3 threadIdx, blockIdx;
inline float* emu_dyn = nullptr;

// A barrier over `expected` fibers: the last to arrive opens it and runs
// on; the others yield to the scheduler until it has opened.
struct EmuBarrier {
  int expected = 0, arrived = 0;
  unsigned gen = 0;
};
struct EmuFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
};
inline std::vector<EmuFiber> emu_fibers;
inline ucontext_t emu_sched_ctx;
inline int emu_cur = 0;
inline long emu_progress = 0;        // arrivals and exits, for the scheduler
inline EmuBarrier emu_block_barrier;
inline std::vector<EmuBarrier> emu_warp_barriers;
inline std::vector<std::vector<double>> emu_shuffle;  // float or double
inline std::function<void()> emu_body;

inline void emu_wait(EmuBarrier& b) {
  const unsigned gen = b.gen;
  ++emu_progress;
  if (++b.arrived == b.expected) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) swapcontext(&emu_fibers[emu_cur].ctx, &emu_sched_ctx);
}

inline void __syncthreads() { emu_wait(emu_block_barrier); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_wait(emu_warp_barriers[threadIdx.x / 32]);
}
// a float goes through the double exchange exactly
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_shuffle[w][l] = v;
  emu_wait(emu_warp_barriers[w]);
  const T r = (T)emu_shuffle[w][l ^ lane_mask];
  emu_wait(emu_warp_barriers[w]);
  return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  const int w = threadIdx.x / 32;
  emu_shuffle[w][threadIdx.x % 32] = v;
  emu_wait(emu_warp_barriers[w]);
  const T r = (T)emu_shuffle[w][src_lane];
  emu_wait(emu_warp_barriers[w]);
  return r;
}
// separately rounded products, sums and differences (no contraction into
// an FMA)
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline double __dadd_rn(double a, double b) {
  volatile double r = a + b;
  return r;
}
inline double __dmul_rn(double a, double b) {
  volatile double r = a * b;
  return r;
}
// fused multiply-adds, one rounding (std::fma, as the card's FFMA / DFMA)
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) {
  return std::fma(a, b, c);
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

inline void emu_fiber_main() {
  emu_body();
  emu_fibers[emu_cur].done = true;
  ++emu_progress;
}

// Each block's CUDA threads as fibers of the calling thread (ucontext), run
// in passes over the block, in thread order and in reverse order by turns:
// a fiber runs until it waits at a barrier or returns.  A pass in which no
// fiber arrives anywhere or returns is a deadlock (a barrier that not every
// thread reaches): the process aborts.
template <class... KA, class... A>
void emu_launch(void (*kernel)(KA...), dim3 grid, dim3 block, size_t smem,
                cudaStream_t, A... args) {
  constexpr size_t kStack = 256 * 1024;
  const int nt = block.x * block.y * block.z;
  std::vector<float4> dyn4(smem / 16 + 1);
  float* dyn = &dyn4[0].x;
  const size_t dyn_n = 4 * dyn4.size();
  emu_body = [&] { kernel(args...); };
  emu_fibers = std::vector<EmuFiber>(nt);
  for (auto& f : emu_fibers) f.stack.reset(new char[kStack]);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        emu_block_barrier = EmuBarrier{nt};
        emu_warp_barriers.assign((nt + 31) / 32, EmuBarrier{32});
        emu_shuffle.assign((nt + 31) / 32, std::vector<double>(32));
        std::fill(dyn, dyn + dyn_n, __int_as_float(0x7fc00000));
        emu_dyn = dyn;
        blockIdx = dim3(x, y, z);
        for (int t = 0; t < nt; ++t) {
          EmuFiber& f = emu_fibers[t];
          f.done = false;
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.get();
          f.ctx.uc_stack.ss_size = kStack;
          f.ctx.uc_link = &emu_sched_ctx;
          makecontext(&f.ctx, emu_fiber_main, 0);
        }
        for (int left = nt, pass = 0; left > 0; ++pass) {
          const long before = emu_progress;
          left = 0;
          for (int i = 0; i < nt; ++i) {
            const int t = pass % 2 ? nt - 1 - i : i;
            if (emu_fibers[t].done) continue;
            emu_cur = t;
            threadIdx = dim3(t);
            swapcontext(&emu_sched_ctx, &emu_fibers[t].ctx);
            left += !emu_fibers[t].done;
          }
          if (left > 0 && emu_progress == before) {
            std::fprintf(stderr, "emu_launch: %d threads wait at barriers "
                         "that the others never reach\n", left);
            std::abort();
          }
        }
      }
  emu_fibers.clear();
}
