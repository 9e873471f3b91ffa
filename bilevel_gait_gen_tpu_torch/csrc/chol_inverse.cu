// chol_inverse: batched explicit inverse of SPD p x p matrices (the Schur
// complement S = (A Mi) A^T + reg I of an interior-point sweep) by the
// Cholesky factorization of the TPU kernel, blocked on 32-wide panels, for p
// up to 320.
//
// Replaces bilevel_gait_gen_tpu/ops/pallas_kernels.py::_chol_inverse_unrolled
// as ::ipm_iter runs it on a sweep with many equality rows (the centroidal
// QP: p = 256).  The TPU kernel unrolls the p x p factorization in VMEM; the
// iteration kernel of ipm_iter.cu factorizes S with one warp in its shared
// memory, which holds S only up to p = 32.  Here one block of 512 threads
// owns one matrix.
//
// Bound: the work is p^3 / 6 FFMA for the factorization, p^3 / 6 for the
// triangular inverse and p^3 / 6 for X X^T (~8.4 M FFMA a matrix at
// p = 256), and 128 matrices fill 128 SMs once, so a matrix's latency on
// one SM is the kernel's time: its chain of dependent steps and how fast
// the SM feeds its FFMA units from shared memory.  A right-looking step per
// pivot (the first version) made that a chain of ~3 p block barriers with
// little work between two.  What the design does about it:
//  * the upper triangle is held as 32 x 32 tiles (I <= J), each with a row
//    stride of 33 floats (no bank conflicts down a column): nb (nb + 1) / 2
//    tiles, nb = ceil(p / 32), 152 KB at p = 256.  Rows and columns from p
//    on are an identity padding, which decouples exactly.  Only the upper
//    rows of S are read; the lower half of a diagonal tile is the kernel's;
//  * blocked Cholesky S = U^T U, nb steps of two barriers each: a thread
//    per column of the panel row solves it (register array, the plain
//    version's steps); then warp 0 updates the next diagonal tile and
//    factors it (the pivot steps in registers and shuffles, in a rolled
//    loop: the pivot floored at 1e-30, the row scaled by 1 / sqrt, the
//    update a separately rounded product and difference) while the other
//    warps give the other trailing tiles the rank-32 update on 4 x 4
//    register tiles (8 shared loads for 16 FFMA);
//  * X = U^-1 by blocks: the diagonal tiles' inverses W first, a warp each
//    (a lane per column, no barrier), kept transposed in the tile's lower
//    half with the diagonal in its 33rd column; then the block rows from
//    the last up, X_IJ = -W_II sum_{I < L <= J} U_IL X_LJ in place, the
//    sums accumulated right-looking so that each step's products spread
//    over the whole block;
//  * Si = X X^T on 4 x 4 register tiles of the upper tiles, each written to
//    its place and its mirror (16-byte stores where p % 4 == 0): Si comes
//    out exactly symmetric.
// ~6 nb block barriers in all.  The sums over a tile's 32 terms run in
// index order with FMA, so a result does not change from run to run.  No
// failure check: a bad pivot gives inf/NaN, as in the TPU kernel.
#include "common.cuh"

namespace bggt {

constexpr int kCholThreads = 512;
constexpr int kCholWarps = kCholThreads / 32;
constexpr int kPan = 32;                  // panel width
constexpr int kLd = kPan + 1;             // row stride of a tile
constexpr int kTileF = kPan * kLd;        // floats a tile
constexpr int kSubs = (kPan / 4) * (kPan / 4);  // 4 x 4 register tiles a tile
constexpr int kMaxRowSubs = 2;  // a thread's register tiles in a block row

inline int chol_blocks(int p) { return (p + kPan - 1) / kPan; }

inline size_t chol_smem_floats(int p) {
  const size_t nb = (size_t)chol_blocks(p);
  return nb * (nb + 1) / 2 * kTileF;
}

// tile (I, J), I <= J, of the packed upper triangle of tiles
__device__ __forceinline__ float* chol_tile(float* T, int I, int J, int nb) {
  return T + (size_t)(I * nb - I * (I - 1) / 2 + (J - I)) * kTileF;
}

// the t-th tile (I, J) of the triangle I0 <= I <= J < nb, row by row
__device__ __forceinline__ void tri_coords(int t, int I0, int nb, int& I,
                                           int& J) {
  I = I0;
  while (t >= nb - I) {
    t -= nb - I;
    ++I;
  }
  J = I + t;
}

// Warp 0: the diagonal tile D = U^T U in place (upper half), 1 / sqrt of
// each pivot kept in column 32 for the panel.  A lane holds its column of
// the trailing block in registers, a[r] being row k + r; the pivot comes by
// shuffle and the finished row k goes to its place in D, from where the
// lanes read it back (broadcast) for the update.  The pivot loop stays
// rolled (unrolled, the 32-pivot loop of gj_inverse.cu stalled on the
// instruction cache).
__device__ void chol_factor_diag(float* D, int lane) {
  float a[kPan];
#pragma unroll
  for (int i = 0; i < kPan; ++i) a[i] = D[i * kLd + lane];
#pragma unroll 1
  for (int k = 0; k < kPan; ++k) {
    const float piv = nan_max(__shfl_sync(0xffffffffu, a[0], k), 1e-30f);
    const float rs = 1.0f / sqrtf(piv);
    const float u = a[0] * rs;
    if (lane >= k) D[k * kLd + lane] = u;
    if (lane == 0) D[k * kLd + kPan] = rs;
    __syncwarp();
    const float* row = D + k * kLd + k;
#pragma unroll
    for (int r = 1; r < kPan; ++r)
      if (r < kPan - k) a[r - 1] = __fsub_rn(a[r], __fmul_rn(row[r], u));
  }
}

// A thread: column c of the panel tile P (row block K) given the factored
// diagonal tile D: the same pivot steps restricted to the column.
__device__ void chol_panel_column(const float* D, float* P, int c) {
  float a[kPan];
#pragma unroll
  for (int r = 0; r < kPan; ++r) a[r] = P[r * kLd + c];
#pragma unroll
  for (int r = 0; r < kPan; ++r) {
    const float u = a[r] * D[r * kLd + kPan];
    a[r] = u;
#pragma unroll
    for (int r2 = r + 1; r2 < kPan; ++r2)
      a[r2] = __fsub_rn(a[r2], __fmul_rn(D[r * kLd + r2], u));
  }
#pragma unroll
  for (int r = 0; r < kPan; ++r) P[r * kLd + c] = a[r];
}

// acc[t][u] += sum_l X(r0 + t, l) Y(l, c0 + u) on a 4 x 4 register tile,
// l ascending, where X(i, l) = X[i * kXi + l * kXl] and Y(l, j) =
// Y[l * kYl + j * kYj]: the strides give X^T Y (TN), X Y (NN), X Y^T (NT)
// of the tiles
template <int kXi, int kXl, int kYl, int kYj>
__device__ __forceinline__ void tile_fma(const float* X, const float* Y,
                                         int r0, int c0, float acc[4][4]) {
#pragma unroll 4
  for (int l = 0; l < kPan; ++l) {
    float x[4], y[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[t] = X[(r0 + t) * kXi + l * kXl];
      y[t] = Y[l * kYl + (c0 + t) * kYj];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[t][u] = fmaf(x[t], y[u], acc[t][u]);
  }
}
__device__ __forceinline__ void tn_tile(const float* X, const float* Y,
                                        int r0, int c0, float acc[4][4]) {
  tile_fma<1, kLd, kLd, 1>(X, Y, r0, c0, acc);
}
__device__ __forceinline__ void nn_tile(const float* X, const float* Y,
                                        int r0, int c0, float acc[4][4]) {
  tile_fma<kLd, 1, kLd, 1>(X, Y, r0, c0, acc);
}
__device__ __forceinline__ void nt_tile(const float* X, const float* Y,
                                        int r0, int c0, float acc[4][4]) {
  tile_fma<kLd, 1, 1, kLd>(X, Y, r0, c0, acc);
}

__device__ __forceinline__ void zero_tile(float acc[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[t][u] = 0.f;
}

// A warp: W = D^-1 of the factored diagonal tile, lane j forming column j
// as the plain version does (row k from the last up: (delta_kj - sum_{l > k}
// U[k, l] W[l, j]) / U[k, k], l ascending), stored transposed in the lower
// half (D[j][k] = W[k][j], k < j) and the diagonal in column 32.  A lane
// reads the upper half and its own row only: no barrier.
__device__ void chol_invert_diag(float* D, int j) {
#pragma unroll 1
  for (int k = j; k >= 0; --k) {
    float acc = 0.f;
    for (int l = k + 1; l <= j; ++l)
      acc = fmaf(D[k * kLd + l], l == j ? D[j * kLd + kPan] : D[j * kLd + l],
                 acc);
    const float val = ((j == k ? 1.f : 0.f) - acc) / D[k * kLd + k];
    if (k == j) D[j * kLd + kPan] = val;
    else D[j * kLd + k] = val;
  }
}

__global__ void __launch_bounds__(kCholThreads)
chol_inverse_kernel(const float* __restrict__ S, float* __restrict__ Si,
                    int p) {
  extern __shared__ float smem[];
  float* T = smem;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nb = (p + kPan - 1) / kPan;
  const int ntiles = nb * (nb + 1) / 2;
  const float* Sb = S + (size_t)blockIdx.x * p * p;
  float* Ob = Si + (size_t)blockIdx.x * p * p;

  // the upper tiles; the diagonal tiles' lower halves 0, the padding I.
  // kLoadTiles tiles a turn, their loads issued before the first store
  constexpr int kLoadTiles = 4, kPer = kPan * kPan / kCholThreads;
  for (int t0 = 0; t0 < ntiles; t0 += kLoadTiles) {
    float v[kLoadTiles][kPer];
#pragma unroll
    for (int dt = 0; dt < kLoadTiles; ++dt) {
      int I, J;
      tri_coords(min(t0 + dt, ntiles - 1), 0, nb, I, J);
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int e = tid + s * kCholThreads, r = e / kPan, c = e % kPan;
        const int i = I * kPan + r, j = J * kPan + c;
        if (i < p && j < p)
          v[dt][s] = (I < J || r <= c) ? Sb[(size_t)i * p + j] : 0.f;
        else
          v[dt][s] = i == j ? 1.f : 0.f;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kLoadTiles; ++dt) {
      if (t0 + dt >= ntiles) break;
      int I, J;
      tri_coords(t0 + dt, 0, nb, I, J);
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int e = tid + s * kCholThreads;
        chol_tile(T, I, J, nb)[(e / kPan) * kLd + e % kPan] = v[dt][s];
      }
    }
  }
  __syncthreads();

  // S = U^T U by block steps.  Warp 0 factors diagonal tile K + 1 (after
  // its share of step K's update) while the other warps update the rest of
  // the trailing tiles, so a factorization waits for no other work
  if (warp == 0) chol_factor_diag(chol_tile(T, 0, 0, nb), lane);
  __syncthreads();
  for (int K = 0; K + 1 < nb; ++K) {
    const int m = nb - 1 - K;
    if (tid < m * kPan)
      chol_panel_column(chol_tile(T, K, K, nb),
                        chol_tile(T, K, K + 1 + tid / kPan, nb), tid % kPan);
    __syncthreads();
    if (warp == 0) {
      const float* U1 = chol_tile(T, K, K + 1, nb);
      float* D1 = chol_tile(T, K + 1, K + 1, nb);
      for (int sb = lane; sb < kSubs; sb += 32) {
        const int r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
        if (r0 > c0) continue;          // below the diagonal: never read
        float acc[4][4];
        zero_tile(acc);
        tn_tile(U1, U1, r0, c0, acc);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u) D1[(r0 + t) * kLd + c0 + u] -= acc[t][u];
      }
      __syncwarp();
      chol_factor_diag(D1, lane);
    } else {
      for (int e = kSubs + tid - 32; e < m * (m + 1) / 2 * kSubs;
           e += kCholThreads - 32) {
        int I, J;
        tri_coords(e / kSubs, 0, m, I, J);
        I += K + 1;
        J += K + 1;
        const int sb = e % kSubs, r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
        if (I == J && r0 > c0) continue;
        float acc[4][4];
        zero_tile(acc);
        tn_tile(chol_tile(T, K, I, nb), chol_tile(T, K, J, nb), r0, c0, acc);
        float* A = chol_tile(T, I, J, nb);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u) A[(r0 + t) * kLd + c0 + u] -= acc[t][u];
      }
    }
    __syncthreads();
  }

  // X = U^-1: the diagonal tiles' inverses W, then by block rows from the
  // last up, right-looking: once row L of X is final (X_LJ = -W_LL T_LJ),
  // its products U_IL X_LJ go into T_IJ = sum_{I < L' <= J} U_IL' X_L'J of
  // every row I above, which replaces U_IJ in place (T_IL = U_IL X_LL at
  // step L, where U_IL is read for the last time).  A step's products are
  // spread over the whole block.
  for (int I = warp; I < nb; I += kCholWarps)
    chol_invert_diag(chol_tile(T, I, I, nb), lane);
  __syncthreads();
  for (int L = nb - 1; L >= 0; --L) {
    float* D = chol_tile(T, L, L, nb);
    const int m = nb - 1 - L;
    float acc[kMaxRowSubs][4][4];
    // row L: X_LJ = -W_LL T_LJ, W[r][l] = D[l][r] (l > r), D[r][32] (l = r)
#pragma unroll
    for (int s = 0; s < kMaxRowSubs; ++s) {
      zero_tile(acc[s]);
      const int e = tid + s * kCholThreads;
      if (e < m * kSubs) {
        const int J = L + 1 + e / kSubs, sb = e % kSubs;
        const int r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
        const float* P = chol_tile(T, L, J, nb);
        for (int l = r0; l < kPan; ++l) {
          float w[4], y[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int r = r0 + t;
            w[t] = l > r ? D[l * kLd + r] : l == r ? D[r * kLd + kPan] : 0.f;
            y[t] = P[l * kLd + c0 + t];
          }
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[s][t][u] = fmaf(w[t], y[u], acc[s][t][u]);
        }
      }
    }
    // and the diagonal tile becomes X_LL = W_LL: upper half W, lower half 0
    float dv[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = tid + s * kCholThreads, r = e / kPan, c = e % kPan;
      dv[s] = r < c ? D[c * kLd + r] : r == c ? D[r * kLd + kPan] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxRowSubs; ++s) {
      const int e = tid + s * kCholThreads;
      if (e < m * kSubs) {
        const int J = L + 1 + e / kSubs, sb = e % kSubs;
        const int r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
        float* P = chol_tile(T, L, J, nb);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            P[(r0 + t) * kLd + c0 + u] = -acc[s][t][u];
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = tid + s * kCholThreads;
      D[(e / kPan) * kLd + e % kPan] = dv[s];
    }
    __syncthreads();
    if (L == 0) break;
    // rows I < L: T_IJ += U_IL X_LJ in place (J > L; tile (I, J) is read
    // by no other product of the step), and T_IL = U_IL X_LL in registers
    for (int e = tid; e < L * m * kSubs; e += kCholThreads) {
      const int t = e / kSubs, I = t / m, J = L + 1 + t % m;
      const int sb = e % kSubs, r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
      float a4[4][4];
      zero_tile(a4);
      nn_tile(chol_tile(T, I, L, nb), chol_tile(T, L, J, nb), r0, c0, a4);
      float* P = chol_tile(T, I, J, nb);
#pragma unroll
      for (int t2 = 0; t2 < 4; ++t2)
#pragma unroll
        for (int u = 0; u < 4; ++u) P[(r0 + t2) * kLd + c0 + u] += a4[t2][u];
    }
#pragma unroll
    for (int s = 0; s < kMaxRowSubs; ++s) {
      zero_tile(acc[s]);
      const int e = tid + s * kCholThreads;
      if (e < L * kSubs) {
        const int sb = e % kSubs, r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
        nn_tile(chol_tile(T, e / kSubs, L, nb), D, r0, c0, acc[s]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxRowSubs; ++s) {
      const int e = tid + s * kCholThreads;
      if (e < L * kSubs) {
        const int sb = e % kSubs, r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
        float* P = chol_tile(T, e / kSubs, L, nb);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u) P[(r0 + t) * kLd + c0 + u] = acc[s][t][u];
      }
    }
    __syncthreads();
  }

  // Si = X X^T: tile (I, J), I <= J, sums X_IL X_JL^T over L >= J; a 4 x 4
  // register tile on or above the diagonal, written to its place and its
  // mirror
  const bool vec = p % 4 == 0;
  for (int e = tid; e < ntiles * kSubs; e += kCholThreads) {
    int I, J;
    tri_coords(e / kSubs, 0, nb, I, J);
    const int sb = e % kSubs, r0 = 4 * (sb / 8), c0 = 4 * (sb % 8);
    if (I == J && r0 > c0) continue;
    float acc[4][4];
    zero_tile(acc);
    for (int L = J; L < nb; ++L)
      nt_tile(chol_tile(T, I, L, nb), chol_tile(T, J, L, nb), r0, c0, acc);
    const int i0 = I * kPan + r0, j0 = J * kPan + c0;
    if (i0 >= p || j0 >= p) continue;
    if (vec && !(I == J && r0 == c0)) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        st4(Ob + (size_t)(i0 + t) * p + j0,
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]));
        st4(Ob + (size_t)(j0 + t) * p + i0,
            make_float4(acc[0][t], acc[1][t], acc[2][t], acc[3][t]));
      }
      continue;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + t, j = j0 + u;
        if (i >= p || j >= p || j < i) continue;
        Ob[(size_t)i * p + j] = acc[t][u];
        Ob[(size_t)j * p + i] = acc[t][u];
      }
  }
}

}  // namespace bggt

BGGT_API int bggt_chol_inverse_smem_bytes(int p) {
  return (int)(bggt::chol_smem_floats(p) * sizeof(float));
}

BGGT_API int bggt_chol_inverse(const float* S, float* Si, int B, int p,
                               void* stream) {
  // the panel takes a thread a column, a block row at most kMaxRowSubs
  // register tiles a thread
  if (p < 1 || (bggt::chol_blocks(p) - 1) * bggt::kSubs >
                   bggt::kMaxRowSubs * bggt::kCholThreads)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_rc =
      bggt::allow_max_dynamic_smem(bggt::chol_inverse_kernel);
  if (smem_rc != cudaSuccess) return (int)smem_rc;
  const size_t bytes = bggt::chol_smem_floats(p) * sizeof(float);
  bggt::chol_inverse_kernel<<<B, bggt::kCholThreads, bytes,
                              (cudaStream_t)stream>>>(S, Si, p);
  return (int)cudaGetLastError();
}
