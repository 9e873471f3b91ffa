// chol_inverse: batched explicit inverse of SPD p x p matrices (the Schur
// complement S = (A Mi) A^T + reg I of an interior-point sweep) by the
// unrolled Cholesky of the TPU kernel, for p up to a few hundred.
//
// Replaces bilevel_gait_gen_tpu/ops/pallas_kernels.py::_chol_inverse_unrolled
// as ::ipm_iter runs it on a sweep with many equality rows (the centroidal
// QP: p = 256).  The TPU kernel unrolls the p x p factorization in VMEM; the
// iteration kernel of ipm_iter.cu factorizes S with one warp in its shared
// memory, which holds S only up to p = 32.  Here one block of 512 threads
// owns one matrix.
//
// Bound: the chain of p dependent pivots, each a rank-1 update of the
// trailing triangle, and the shared memory's bandwidth inside a step (the
// work is p^3 / 3 FFMA for the factorization, p^3 / 6 for the triangular
// inverse, p^3 / 3 for X X^T: ~0.02 GFLOP a matrix at p = 256, far below
// what an SM can do in the time the 2 p barriers take).  What the design
// does about it:
//  * only the upper triangle is read (as the TPU kernel reads only the upper
//    rows), so it is held packed, row by row: p (p + 1) / 2 floats, 132 KB
//    at p = 256, which fits a block's shared memory where the square matrix
//    (256 KB) does not.  The matrix crosses device memory once in, once
//    out;
//  * the factorization is right-looking, step k scaling row k into a
//    staging row and updating the trailing triangle from it, a warp to a
//    row and the lanes along it (conflict-free, the pivot row's entries a
//    broadcast);
//  * X = U^-1 is formed in place over U, rows from the last up: row k of X
//    needs only row k of U and the rows of X below it, so a thread per
//    column computes its entry, the block waits, and the row is written;
//  * Si = X X^T by 4 x 4 register tiles on and above the diagonal (8 loads
//    for 16 FFMA), each written to its place and its mirror: Si comes out
//    exactly symmetric.
// The arithmetic follows the plain version (ops/kernels.py::
// chol_inverse_unrolled) step by step: the pivot floored at 1e-30, the
// update as a separately rounded product and difference, the division by
// the pivot; sums over l ascending.  No failure check: a bad pivot gives
// inf/NaN, as in the TPU kernel.
#include "common.cuh"

namespace bggt {

constexpr int kCholThreads = 512;
constexpr int kCholWarps = kCholThreads / 32;

// offset of row i of the packed upper triangle (row i holds columns i..p-1)
__device__ __forceinline__ int packed_row(int i, int p) {
  return i * p - i * (i - 1) / 2;
}

inline size_t chol_smem_floats(int p) {
  return (size_t)p * (p + 1) / 2 + (size_t)p;
}

__global__ void __launch_bounds__(kCholThreads)
chol_inverse_kernel(const float* __restrict__ S, float* __restrict__ Si,
                    int p) {
  extern __shared__ float smem[];
  float* T = smem;                                  // packed upper triangle
  float* row = smem + (size_t)p * (p + 1) / 2;      // staging row, p floats
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* Sb = S + (size_t)blockIdx.x * p * p;
  float* Ob = Si + (size_t)blockIdx.x * p * p;

  for (int i = warp; i < p; i += kCholWarps)
    for (int j = i + lane; j < p; j += 32)
      T[packed_row(i, p) + j - i] = Sb[(size_t)i * p + j];
  __syncthreads();

  // S = U^T U, U upper: row k of U is the trailing row k over sqrt(pivot)
  for (int k = 0; k < p; ++k) {
    const int ok = packed_row(k, p) - k;
    const float piv = nan_max(T[ok + k], 1e-30f);
    const float rs = 1.0f / sqrtf(piv);
    for (int j = k + threadIdx.x; j < p; j += kCholThreads)
      row[j] = T[ok + j] * rs;
    __syncthreads();
    for (int j = k + threadIdx.x; j < p; j += kCholThreads) T[ok + j] = row[j];
    for (int i = k + 1 + warp; i < p; i += kCholWarps) {
      const float ui = row[i];
      float* Ti = T + packed_row(i, p) - i;
      for (int j = i + lane; j < p; j += 32)
        Ti[j] = __fsub_rn(Ti[j], __fmul_rn(row[j], ui));
    }
    __syncthreads();
  }

  // X = U^-1 in place: X[k, j] = (delta_kj - sum_{l=k+1..j} U[k, l] X[l, j])
  // / U[k, k] for j >= k; a thread per column (p <= kCholThreads)
  for (int k = p - 1; k >= 0; --k) {
    float* Uk = T + packed_row(k, p) - k;
    const int j = k + threadIdx.x;
    float val = 0.f;
    if (j < p) {
      float acc = 0.f;
      for (int l = k + 1; l <= j; ++l)
        acc = fmaf(Uk[l], T[packed_row(l, p) + j - l], acc);
      val = ((j == k ? 1.f : 0.f) - acc) / Uk[k];
    }
    __syncthreads();
    if (j < p) Uk[j] = val;
    __syncthreads();
  }

  // Si = X X^T: tile (a, b), a <= b, covers rows 4a.. and columns 4b..;
  // entry (i, j) sums X[i, l] X[j, l] over l >= max(i, j) ascending
  const int nt = (p + 3) / 4;
  for (int a = warp; a < nt; a += kCholWarps) {
    for (int b = a + lane; b < nt; b += 32) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int l = 4 * b; l < p; ++l) {
        float xi[4], xj[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * a + r, j = 4 * b + r;
          xi[r] = (i < p && l >= i) ? T[packed_row(i, p) + l - i] : 0.f;
          xj[r] = (j < p && l >= j) ? T[packed_row(j, p) + l - j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(xi[r], xj[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * a + r;
        if (i >= p) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * b + c;
          if (j >= p || j < i) continue;
          Ob[(size_t)i * p + j] = acc[r][c];
          Ob[(size_t)j * p + i] = acc[r][c];
        }
      }
    }
  }
}

}  // namespace bggt

BGGT_API int bggt_chol_inverse_smem_bytes(int p) {
  return (int)(bggt::chol_smem_floats(p) * sizeof(float));
}

BGGT_API int bggt_chol_inverse(const float* S, float* Si, int B, int p,
                               void* stream) {
  if (p < 1 || p > bggt::kCholThreads) return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_rc =
      bggt::allow_max_dynamic_smem(bggt::chol_inverse_kernel);
  if (smem_rc != cudaSuccess) return (int)smem_rc;
  const size_t bytes = bggt::chol_smem_floats(p) * sizeof(float);
  bggt::chol_inverse_kernel<<<B, bggt::kCholThreads, bytes,
                              (cudaStream_t)stream>>>(S, Si, p);
  return (int)cudaGetLastError();
}
