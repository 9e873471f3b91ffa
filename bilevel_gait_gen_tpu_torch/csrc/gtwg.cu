// gtwg: batched M = H + G^T diag(W) G + reg I, and the square GEMM of the
// Newton-Schulz refresh.
//
// Replaces bilevel_gait_gen_tpu/ops/pallas_kernels.py::gtwg (and the M
// formation and NS products inside ::ipm_iter).  The TPU kernel walks a
// sequential K grid axis over 512-row slabs of G with a 128x128 VMEM
// accumulator; here one block owns a 64x64 output tile of one problem and
// loops over the rows of G itself, since Hopper's blocks run in parallel and
// carry nothing from one to the next.
//
// Bound: at the main path's shape (512 problems, n = 256, m = 1280) one
// call is 2*n*n*m*B = 86 GFLOP of FFMA against ~0.7 GB of G and H, so it is
// compute bound on the FP32 pipes (no tensor-core path keeps FP32 inputs).
// The simple design keeps 16x64 slabs of both G column strips in shared
// memory and gives each of 256 threads a 4x4 register tile; the diagonal
// scaling by W is applied as the slab is loaded.  Ragged n and m are masked.
#include "common.cuh"

namespace bggt {

constexpr int kTile = 64;
constexpr int kSlab = 16;
constexpr int kGemmThreads = 256;

// out[b] = H[b] + sum_k w_k G[b,k,:]^T G[b,k,:] + reg I
// with w = W[b] if W is given, else clip(lam[b] / s[b], w_lo, w_hi).
__global__ void __launch_bounds__(kGemmThreads)
gtwg_kernel(const float* __restrict__ H, const float* __restrict__ G,
            const float* __restrict__ W, const float* __restrict__ lam,
            const float* __restrict__ s, float* __restrict__ out, int m,
            int n, float reg, float w_lo, float w_hi) {
  __shared__ float gi_s[kSlab][kTile];   // W-scaled G slab, columns i0..
  __shared__ float gj_s[kSlab][kTile];   // G slab, columns j0..
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* Gb = G + (size_t)b * m * n;
  const size_t woff = (size_t)b * m;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kSlab) {
    for (int e = threadIdx.x; e < kSlab * kTile; e += kGemmThreads) {
      const int kk = e / kTile, cc = e % kTile;
      const int k = k0 + kk;
      float wk = 0.f, gi = 0.f, gj = 0.f;
      if (k < m) {
        wk = W != nullptr ? W[woff + k]
                          : clip(lam[woff + k] / s[woff + k], w_lo, w_hi);
        if (i0 + cc < n) gi = Gb[(size_t)k * n + i0 + cc];
        if (j0 + cc < n) gj = Gb[(size_t)k * n + j0 + cc];
      }
      gi_s[kk][cc] = gi * wk;
      gj_s[kk][cc] = gj;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = gi_s[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = gj_s[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  const size_t hoff = (size_t)b * n * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < n && j < n) {
        const size_t o = hoff + (size_t)i * n + j;
        float v = acc[r][c] + H[o];
        if (i == j) v += reg;
        out[o] = v;
      }
    }
  }
}

// C[b] = alpha * A[b] @ B[b] + diag * I, all [n, n] row-major.
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
            float* __restrict__ C, int n, float alpha, float diag) {
  __shared__ float a_s[kSlab][kTile];    // a_s[kk][ii] = A[i0 + ii, k0 + kk]
  __shared__ float b_s[kSlab][kTile];    // b_s[kk][jj] = B[k0 + kk, j0 + jj]
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t off = (size_t)b * n * n;
  const float* Ab = A + off;
  const float* Bb = Bm + off;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kSlab) {
    for (int e = threadIdx.x; e < kSlab * kTile; e += kGemmThreads) {
      // A: consecutive threads walk k within a row of A
      const int ii = e / kSlab, kk = e % kSlab;
      const int i = i0 + ii, k = k0 + kk;
      a_s[kk][ii] = (i < n && k < n) ? Ab[(size_t)i * n + k] : 0.f;
      const int kb = e / kTile, jj = e % kTile;
      const int kr = k0 + kb, j = j0 + jj;
      b_s[kb][jj] = (kr < n && j < n) ? Bb[(size_t)kr * n + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = a_s[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b_s[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < n && j < n) {
        float v = alpha * acc[r][c];
        if (i == j) v += diag;
        C[off + (size_t)i * n + j] = v;
      }
    }
  }
}

}  // namespace bggt

BGGT_API int bggt_gtwg(const float* H, const float* G, const float* W,
                       const float* lam, const float* s, float* out, int B,
                       int m, int n, float reg, float w_lo, float w_hi,
                       void* stream) {
  const int t = (n + bggt::kTile - 1) / bggt::kTile;
  dim3 grid(t, t, B);
  bggt::gtwg_kernel<<<grid, bggt::kGemmThreads, 0, (cudaStream_t)stream>>>(
      H, G, W, lam, s, out, m, n, reg, w_lo, w_hi);
  return (int)cudaGetLastError();
}

BGGT_API int bggt_gemm(const float* A, const float* Bm, float* C, int B,
                       int n, float alpha, float diag, void* stream) {
  const int t = (n + bggt::kTile - 1) / bggt::kTile;
  dim3 grid(t, t, B);
  bggt::gemm_kernel<<<grid, bggt::kGemmThreads, 0, (cudaStream_t)stream>>>(
      A, Bm, C, n, alpha, diag);
  return (int)cudaGetLastError();
}

BGGT_API const char* bggt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
