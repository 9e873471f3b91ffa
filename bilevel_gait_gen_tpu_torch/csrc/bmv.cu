// bmv: batched dot products out[z, a, b] = sum_k X[z, a, k] * Y[z, b, k],
// float32 or float64, each entry summed in an order fixed by the reduction
// length K alone.
//
// The per-scenario products of utils/jnp_compat.py on the card (matvec:
// Y = v as one row; vecmat: X = M^T, a transposed view or a contiguous
// copy; matmul_nt: X Y^T) and the IK's.  cuBLAS's batched GEMV and small
// batched GEMM pick their kernel, and how they split a row's sum, by the
// batch count, so one scenario's bits changed with the number of scenarios
// beside it.  Here nothing of the launch enters an entry's arithmetic: the
// batch count, the grid and the number of outputs pick which thread or warp
// computes an entry, never the order in which it is summed.
//
// The order (the contract; tests/test_torch_kernels_bmv.py holds the host
// build of this file to it):
//  * K <= kSeqMax (32): one thread an entry, an FMA chain over k ascending,
//    acc = X_0 Y_0, then acc = fma(X_k, Y_k, acc) for k = 1 .. K-1;
//  * K > kSeqMax: one warp an entry; lane l runs the FMA chain over
//    k = l, l + 32, l + 64, ... ascending from its first product, then the
//    32 partial sums meet in a fixed xor butterfly (offsets 16, 8, 4, 2, 1;
//    an add is commutative, so every lane holds the same total) and lane 0
//    writes it.
// K = 0 gives 0.
//
// Operands are addressed by strides (in elements): the batch index z is up
// to three broadcast axes (kMaxAxes) of sizes nz[0..2], X's and Y's batch
// strides per axis (0 where an operand is broadcast: one vector over many
// matrices, one [3, 3] matrix over a batch of vectors), then each operand's
// row and k strides, so a transposed or otherwise strided view is read in
// place.  The output is contiguous [Z, A, Bn].
//
// Bound: bytes.  Each entry reads K elements of X and of Y and does K
// multiply-adds; at the call sites' shapes every launch is a few hundred
// KB to a few MB, far from FFMA throughput, and a batch-1 launch is one
// launch's latency.  No shared memory, no tensor cores: a simple kernel
// whose order is right.
#include "common.cuh"

namespace bggt {

constexpr int kBmvThreads = 128;
constexpr int kSeqMax = 32;
constexpr int kMaxAxes = 3;

struct BmvArgs {
  const void* X;
  const void* Y;
  void* out;
  long long sx[kMaxAxes], sy[kMaxAxes];  // batch strides, outermost first
  long long sxa, sxk, syb, syk;          // row and k strides
  int nz[kMaxAxes];                      // batch sizes, outermost first
  int A, Bn, K;
  long long n_out;                       // Z A Bn
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the offsets of entry e's row of X and row of Y
__device__ __forceinline__ void bmv_offsets(const BmvArgs& a, long long e,
                                            long long& ox, long long& oy) {
  const long long b = e % a.Bn;
  long long t = e / a.Bn;
  const long long r = t % a.A;
  t /= a.A;
  ox = r * a.sxa;
  oy = b * a.syb;
  for (int ax = kMaxAxes - 1; ax >= 0; --ax) {
    const long long i = t % a.nz[ax];
    t /= a.nz[ax];
    ox += i * a.sx[ax];
    oy += i * a.sy[ax];
  }
}

template <class T>
__device__ __forceinline__ void bmv_thread_body(const BmvArgs& a) {
  const long long e = (long long)blockIdx.x * kBmvThreads + threadIdx.x;
  if (e >= a.n_out) return;
  long long ox, oy;
  bmv_offsets(a, e, ox, oy);
  const T* __restrict__ x = static_cast<const T*>(a.X) + ox;
  const T* __restrict__ y = static_cast<const T*>(a.Y) + oy;
  T acc = 0;
  if (a.K > 0) acc = x[0] * y[0];
  for (int k = 1; k < a.K; ++k)
    acc = fma_rn(x[k * a.sxk], y[k * a.syk], acc);
  static_cast<T*>(a.out)[e] = acc;
}

template <class T>
__device__ __forceinline__ void bmv_warp_body(const BmvArgs& a) {
  const long long e =
      (long long)blockIdx.x * (kBmvThreads / 32) + threadIdx.x / 32;
  if (e >= a.n_out) return;          // a whole warp leaves together
  const int lane = threadIdx.x % 32;
  long long ox, oy;
  bmv_offsets(a, e, ox, oy);
  const T* __restrict__ x = static_cast<const T*>(a.X) + ox;
  const T* __restrict__ y = static_cast<const T*>(a.Y) + oy;
  // K > 32: every lane has a first product
  T acc = x[lane * a.sxk] * y[lane * a.syk];
  for (int k = lane + 32; k < a.K; k += 32)
    acc = fma_rn(x[k * a.sxk], y[k * a.syk], acc);
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) static_cast<T*>(a.out)[e] = acc;
}

__global__ void __launch_bounds__(kBmvThreads)
    bmv_thread_f32_kernel(BmvArgs a) {
  bmv_thread_body<float>(a);
}
__global__ void __launch_bounds__(kBmvThreads)
    bmv_thread_f64_kernel(BmvArgs a) {
  bmv_thread_body<double>(a);
}
__global__ void __launch_bounds__(kBmvThreads)
    bmv_warp_f32_kernel(BmvArgs a) {
  bmv_warp_body<float>(a);
}
__global__ void __launch_bounds__(kBmvThreads)
    bmv_warp_f64_kernel(BmvArgs a) {
  bmv_warp_body<double>(a);
}

}  // namespace bggt

// dtype: 0 float32, 1 float64.  nz, sx, sy: kMaxAxes batch axes, outermost
// first (size 1 and stride 0 for an axis not used).  Returns a CUDA error
// code: cudaErrorInvalidValue for a shape the kernel does not take.
BGGT_API int bggt_bmv(const void* X, const void* Y, void* out, int dtype,
                      int nz0, int nz1, int nz2, long long sx0,
                      long long sx1, long long sx2, long long sy0,
                      long long sy1, long long sy2, long long sxa,
                      long long sxk, long long syb, long long syk, int A,
                      int Bn, int K, void* stream) {
  if ((dtype != 0 && dtype != 1) || nz0 < 1 || nz1 < 1 || nz2 < 1 ||
      A < 1 || Bn < 1 || K < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_out = (long long)nz0 * nz1 * nz2 * A * Bn;
  bggt::BmvArgs a{X, Y, out, {sx0, sx1, sx2}, {sy0, sy1, sy2}, sxa, sxk,
                  syb, syk, {nz0, nz1, nz2}, A, Bn, K, n_out};
  const bool warp = K > bggt::kSeqMax;
  const long long per_block =
      warp ? bggt::kBmvThreads / 32 : bggt::kBmvThreads;
  const long long blocks = (n_out + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (warp && dtype == 0)
    bggt::bmv_warp_f32_kernel<<<grid, bggt::kBmvThreads, 0, s>>>(a);
  else if (warp)
    bggt::bmv_warp_f64_kernel<<<grid, bggt::kBmvThreads, 0, s>>>(a);
  else if (dtype == 0)
    bggt::bmv_thread_f32_kernel<<<grid, bggt::kBmvThreads, 0, s>>>(a);
  else
    bggt::bmv_thread_f64_kernel<<<grid, bggt::kBmvThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
