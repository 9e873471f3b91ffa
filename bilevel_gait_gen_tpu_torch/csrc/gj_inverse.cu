// gj_inverse: batched in-place Gauss-Jordan inverse of SPD [n, n] matrices
// without pivoting.
//
// Replaces bilevel_gait_gen_tpu/ops/pallas_kernels.py::gj_inverse (kernel
// bodies _gj_kernel_blocked, _gj_block and _gj_kernel).  It computes the same
// function per matrix:
//
//  * scalar form (any n): n elimination steps, each a masked rank-1 update
//    of the whole matrix; a pivot with |p| < 1e-30 is replaced by 1e-30 and
//    the elimination goes on (no rescue beyond that);
//  * blocked form (n a multiple of the block width kW): per diagonal block J
//      Dinv   = scalar-GJ inverse of D = A[J, J], polished once,
//               Dinv <- Dinv (2 I - D Dinv)
//      rowJ   = Dinv @ (A[J, :] with block J := I)          (row panel)
//      colz   = A[:, J] with block J := 0
//      A     -= colz @ rowJ                                 (rank-kW update)
//      A[J, :] = rowJ;  A[:, J] = -colz @ Dinv with block J := Dinv.
//
// The TPU kernel keeps the whole matrix in VMEM and uses the 128-wide matrix
// unit for the panels.  One [256, 256] float32 matrix is 256 KB, more than
// the 227 KB of shared memory a Hopper block may use, so here one block owns
// one matrix, the matrix lives in the output buffer in device memory (a
// batch of 128 is 32 MB and stays in the 50 MB L2) and only the diagonal
// block and the two panels of the current step are staged in shared memory.
// The block width is 32 (a warp per row of the diagonal block), not the
// TPU's lane width: the width changes rounding, not the function, and the
// plain version takes it as a parameter.
//
// Bound: 2 n^3 flop and 2 n^2 floats of traffic per matrix put the card's
// limit far below what a chain of n dependent pivot steps with block-wide
// barriers can reach; the kernel is latency bound on that chain and on the
// per-block panel products (FP32 FFMA, IEEE; no tensor cores, no TF32).
#include "common.cuh"

namespace bggt {

constexpr int kW = 32;            // block width of the blocked form
constexpr int kGjThreads = 256;
constexpr int kColLd = kW + 1;    // padded row length of the column panel

// In-place scalar Gauss-Jordan inverse of the [n, n] matrix at A (row
// length ld; shared or device memory), by the whole block.  rowb and colb
// hold n floats each.  The product and the subtraction round separately, as
// the plain version's do.
__device__ void gj_scalar(float* A, int ld, int n, float* rowb, float* colb) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    const float p = A[(size_t)j * ld + j];
    const float pinv = 1.0f / (fabsf(p) < 1e-30f ? 1e-30f : p);
    for (int c = tid; c < n; c += kGjThreads) {
      rowb[c] = (c == j ? 1.0f : A[(size_t)j * ld + c]) * pinv;
      colb[c] = c == j ? 0.0f : A[(size_t)c * ld + j];
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += kGjThreads) {
      const int r = e / n, c = e - r * n;
      float v;
      if (c == j)
        v = pinv * ((r == j ? 1.0f : 0.0f) - colb[r]);
      else if (r == j)
        v = rowb[c];
      else
        v = __fsub_rn(A[(size_t)r * ld + c], __fmul_rn(colb[r], rowb[c]));
      A[(size_t)r * ld + c] = v;
    }
    __syncthreads();
  }
}

// Scalar form, any n: the matrix stays in device memory.
__global__ void __launch_bounds__(kGjThreads)
gj_scalar_kernel(const float* __restrict__ M, float* __restrict__ out,
                 int n) {
  extern __shared__ float smem[];
  float* A = out + (size_t)blockIdx.x * n * n;
  const float* Min = M + (size_t)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * n; e += kGjThreads) A[e] = Min[e];
  __syncthreads();
  gj_scalar(A, n, n, smem, smem + n);
}

// Blocked form, n % kW == 0.  Shared memory: D, Dinv, T [kW][kW]; the row
// panel and its product [kW][n] each; the column panel [n][kColLd].
__global__ void __launch_bounds__(kGjThreads)
gj_blocked_kernel(const float* __restrict__ M, float* __restrict__ out,
                  int n) {
  extern __shared__ float smem[];
  float* D = smem;
  float* Dinv = D + kW * kW;
  float* T = Dinv + kW * kW;
  float* rowP = T + kW * kW;             // A[J, :] with block J := I
  float* rowM = rowP + kW * n;           // Dinv @ rowP
  float* colP = rowM + kW * n;           // A[:, J] with block J := 0
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kGjThreads / 32;
  float* A = out + (size_t)blockIdx.x * n * n;
  const float* Min = M + (size_t)blockIdx.x * n * n;
  for (int e = tid; e < n * n; e += kGjThreads) A[e] = Min[e];
  __syncthreads();

  for (int lo = 0; lo < n; lo += kW) {
    // ---- stage the diagonal block and the two panels ---------------------
    for (int e = tid; e < kW * n; e += kGjThreads) {
      const int r = e / n, c = e - r * n;
      const bool in_j = c >= lo && c < lo + kW;
      const float v = A[(size_t)(lo + r) * n + c];
      rowP[e] = in_j ? (c - lo == r ? 1.0f : 0.0f) : v;
      if (in_j) {
        D[r * kW + c - lo] = v;
        Dinv[r * kW + c - lo] = v;
      }
    }
    for (int e = tid; e < n * kW; e += kGjThreads) {
      const int i = e / kW, k = e - i * kW;
      const bool in_j = i >= lo && i < lo + kW;
      colP[i * kColLd + k] = in_j ? 0.0f : A[(size_t)i * n + lo + k];
    }
    __syncthreads();

    // ---- Dinv = inv(D), then one polish step -----------------------------
    gj_scalar(Dinv, kW, kW, T, T + kW);
    float acc4[kW / kWarps];
#pragma unroll
    for (int q = 0; q < kW / kWarps; ++q) {          // T = 2 I - D @ Dinv
      const int r = warp + kWarps * q;
      float a = 0.0f;
      for (int k = 0; k < kW; ++k)
        a = fmaf(D[r * kW + k], Dinv[k * kW + lane], a);
      T[r * kW + lane] = (r == lane ? 2.0f : 0.0f) - a;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kW / kWarps; ++q) {          // Dinv @ T
      const int r = warp + kWarps * q;
      float a = 0.0f;
      for (int k = 0; k < kW; ++k)
        a = fmaf(Dinv[r * kW + k], T[k * kW + lane], a);
      acc4[q] = a;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kW / kWarps; ++q)
      Dinv[(warp + kWarps * q) * kW + lane] = acc4[q];
    __syncthreads();

    // ---- row panel: rowM = Dinv @ rowP, written to A[J, :] ---------------
    for (int c = tid; c < n; c += kGjThreads) {
      float acc[kW];
#pragma unroll
      for (int r = 0; r < kW; ++r) acc[r] = 0.0f;
      for (int k = 0; k < kW; ++k) {
        const float b = rowP[k * n + c];
#pragma unroll
        for (int r = 0; r < kW; ++r)
          acc[r] = fmaf(Dinv[r * kW + k], b, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kW; ++r) {
        rowM[r * n + c] = acc[r];
        A[(size_t)(lo + r) * n + c] = acc[r];
      }
    }
    // ---- column panel: A[:, J] = -(colP @ Dinv) off the block rows -------
    for (int i = warp; i < n; i += kWarps) {
      if (i >= lo && i < lo + kW) continue;           // rows J hold rowM
      float a = 0.0f;
      for (int k = 0; k < kW; ++k)
        a = fmaf(colP[i * kColLd + k], Dinv[k * kW + lane], a);
      A[(size_t)i * n + lo + lane] = -a;
    }
    __syncthreads();                                  // rowM complete

    // ---- rank-kW update of everything outside row and column panel J ----
    // 64 x 64 tiles, 4 x 4 outputs per thread at stride 16
    const int tx = tid % 16, ty = tid / 16;
    for (int i0 = 0; i0 < n; i0 += 64) {
      for (int j0 = 0; j0 < n; j0 += 64) {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
        int ri[4], cj[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ri[r] = min(i0 + ty + 16 * r, n - 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) cj[c] = min(j0 + tx + 16 * c, n - 1);
        for (int k = 0; k < kW; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = colP[ri[r] * kColLd + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = rowM[k * n + cj[c]];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i >= n || (i >= lo && i < lo + kW)) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            if (j >= n || (j >= lo && j < lo + kW)) continue;
            A[(size_t)i * n + j] -= acc[r][c];
          }
        }
      }
    }
    __syncthreads();                                  // A ready for block J+1
  }
}

}  // namespace bggt

// Bytes of dynamic shared memory the blocked kernel needs at size n.
BGGT_API int bggt_gj_smem_bytes(int n) {
  return (int)sizeof(float) * (3 * bggt::kW * bggt::kW + 2 * bggt::kW * n +
                               n * bggt::kColLd);
}

BGGT_API int bggt_gj_block_width() { return bggt::kW; }

// out[b] = inv(M[b]) for B matrices [n, n]; blocked != 0 selects the blocked
// form (n must then be a multiple of the block width).
BGGT_API int bggt_gj_inverse(const float* M, float* out, int B, int n,
                             int blocked, void* stream) {
  if (blocked) {
    if (n % bggt::kW != 0) return (int)cudaErrorInvalidValue;
    const int smem = bggt_gj_smem_bytes(n);
    cudaError_t rc = cudaFuncSetAttribute(
        bggt::gj_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
    bggt::gj_blocked_kernel<<<B, bggt::kGjThreads, smem,
                              (cudaStream_t)stream>>>(M, out, n);
  } else {
    const int smem = (int)sizeof(float) * 2 * n;
    bggt::gj_scalar_kernel<<<B, bggt::kGjThreads, smem,
                             (cudaStream_t)stream>>>(M, out, n);
  }
  return (int)cudaGetLastError();
}
