// gtwg: batched M = H + G^T diag(W) G + reg I, and the square GEMM of the
// Newton-Schulz refresh.
//
// Replaces bilevel_gait_gen_tpu/ops/pallas_kernels.py::gtwg (and the M
// formation and NS products inside ::ipm_iter).  The TPU kernel walks a
// sequential K grid axis over 512-row slabs of G with a 128x128 VMEM
// accumulator; here one block owns a 128x128 output tile of one problem and
// loops over the rows of G itself, since Hopper's blocks run in parallel and
// carry nothing from one to the next.
//
// Bound: FP32 FFMA throughput (no tensor-core path keeps FP32 inputs).  At
// the main path's shape (512 problems, n = 256, m = 1280) the triangle of M
// is B m n (n + 1) = 43 GFLOP against ~0.9 GB of G, H and M.  What the
// design does about it:
//  * symmetry: G^T W G is symmetric, so only the tiles on and above the
//    diagonal are computed (3 of 4 at n = 256); a tile writes its entries
//    with j >= i directly and the same sums, staged through shared memory so
//    that the stores stay coalesced, to their mirrored places.  H is added
//    where each element is written (H is not assumed symmetric), reg on the
//    diagonal.  On and above the diagonal an entry is, bit for bit,
//    fmaf(g_ki * w_k, g_kj, .) over k in ascending order, then + H (+ reg),
//    what the plain version's matrix product gives on the card; below the
//    diagonal it is the mirrored sum, which differs from the plain version's
//    by the rounding of g_kj * w_k in place of g_ki * w_k in each term.  So
//    G^T W G comes out exactly symmetric, and M is when H is;
//  * an 8x8 register tile per thread (256 threads), its fragments read from
//    shared memory as 16-byte loads: 4 loads for 64 FFMA, so the FP32 pipe
//    and not the shared-memory pipe is the limit.  The loads are conflict free
//    (16 neighbouring lanes read 256 consecutive bytes, the two row groups of
//    a warp are broadcasts);
//  * 16-row slabs of the two column strips of G arrive by 16-byte cp.async
//    into a ring of kStages stages, so the loads of later slabs run under the
//    arithmetic of this one.  An asynchronous copy cannot scale by W on the
//    way, so W = clip(lam / s) of a slab is formed once per slab in shared
//    memory and each thread scales, in place and one slab ahead, the pieces
//    of the first strip that it copied itself (8 multiplies per thread and
//    slab instead of 8 per 64 FFMA on the fragments);
//  * on a diagonal tile the quadrant below the diagonal is left out: 2.5
//    tiles' worth of FFMA per problem at n = 256 instead of 4;
//  * 128-wide symmetric tiles read 6 column strips of 128 per problem at
//    n = 256 where the 64-wide full grid read 32 of 64: G crosses L2 three
//    times, not eight.
// Ragged n and m are masked; the 16-byte path needs n % 4 == 0 and 16-byte
// aligned operands (the wrapper checks), any other n takes scalar copies in
// the same kernels.
#include "common.cuh"

namespace bggt {

constexpr int kTile = 128;         // edge of an output tile
constexpr int kSlab = 16;          // depth (rows of G / of B) of one stage
constexpr int kStages = 4;         // stages of the staging ring
constexpr int kGemmThreads = 256;  // 16 x 16 threads, an 8x8 tile each
constexpr int kStripFloats = kSlab * kTile;
constexpr int kStageFloats = 2 * kStripFloats;
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kMirrorStride = kTile + 1;   // odd: conflict-free row reads
constexpr int kMirrorFloats = kTile * kMirrorStride;
// the ring and the slabs of W; the mirror staging reuses the ring's room
constexpr int kGemmSmemFloats =
    (kRingFloats + kStages * kSlab > kMirrorFloats)
        ? kRingFloats + kStages * kSlab
        : kMirrorFloats;

// rows x cols floats from src (row stride ld, valid_rows x valid_cols of it
// in range) into dst (row stride cols), zeros elsewhere; cols % 4 == 0.
// vec: 16-byte cp.async, where ld % 4 == 0 and valid_cols % 4 == 0 make
// every chunk whole; else scalar copies.
__device__ __forceinline__ void stage_block(float* dst, const float* src,
                                            int ld, int rows, int cols,
                                            int valid_rows, int valid_cols,
                                            bool vec) {
  const int chunks_per_row = cols / 4;
  for (int e = threadIdx.x; e < rows * chunks_per_row; e += kGemmThreads) {
    const int r = e / chunks_per_row, c = (e % chunks_per_row) * 4;
    float* d = dst + r * cols + c;
    const float* g = src + (size_t)r * ld + c;
    if (vec) {
      if (r < valid_rows && c < valid_cols) cp_async_16(d, g);
      else st4(d, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        d[t] = (r < valid_rows && c + t < valid_cols) ? g[t] : 0.f;
    }
  }
}

// acc[rh*4 + r][ch*4 + c] += a[r] * b[c]: one 4x4 quadrant of the 8x8
// register tile
__device__ __forceinline__ void outer4(float (&acc)[8][8], int rh, int ch,
                                       float4 a4, float4 b4) {
  const float a[4] = {a4.x, a4.y, a4.z, a4.w};
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[rh * 4 + r][ch * 4 + c] =
          fmaf(a[r], b[c], acc[rh * 4 + r][ch * 4 + c]);
}

// One slab of gtwg: a from the W-scaled strip gi, b from the strip gj.  On
// a diagonal tile the quadrant of rows 64.. and columns ..63 lies below the
// diagonal for every thread; its entries come from the mirror, so it is
// not computed (a quarter of the tile's work).
template <bool kDiag>
__device__ __forceinline__ void gtwg_slab(float (&acc)[8][8], const float* gi,
                                          const float* gj, int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < kSlab; ++kk) {
    const float4 a0 = ld4(gi + kk * kTile + ty * 4);
    const float4 a1 = ld4(gi + kk * kTile + 64 + ty * 4);
    const float4 b0 = ld4(gj + kk * kTile + tx * 4);
    const float4 b1 = ld4(gj + kk * kTile + 64 + tx * 4);
    outer4(acc, 0, 0, a0, b0);
    outer4(acc, 0, 1, a0, b1);
    if (!kDiag) outer4(acc, 1, 0, a1, b0);
    outer4(acc, 1, 1, a1, b1);
  }
}

// thread (tx, ty) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3} of the
// tile and columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
__device__ __forceinline__ int tile_index(int t, int q) {
  return (q / 4) * 64 + t * 4 + q % 4;
}

// out[b] = H[b] + sum_k w_k G[b,k,:]^T G[b,k,:] + reg I
// with w = W[b] if W is given, else clip(lam[b] / s[b], w_lo, w_hi).
// grid.x walks the tile pairs (ti <= tj) row by row, grid.z the problems.
__global__ void __launch_bounds__(kGemmThreads, 2)
gtwg_kernel(const float* __restrict__ H, const float* __restrict__ G,
            const float* __restrict__ W, const float* __restrict__ lam,
            const float* __restrict__ s, float* __restrict__ out, int m,
            int n, float reg, float w_lo, float w_hi, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w_ring = smem + kRingFloats;
  const int tiles = (n + kTile - 1) / kTile;
  int ti = 0, tj = blockIdx.x;
  while (tj >= tiles - ti) { tj -= tiles - ti; ++ti; }
  tj += ti;
  const bool diag = ti == tj;
  const int b = blockIdx.z;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* Gb = G + (size_t)b * m * n;
  const size_t woff = (size_t)b * m;
  const int nslab = (m + kSlab - 1) / kSlab;

  // both strips of a slab (a diagonal tile loads its one strip twice: the
  // first copy gets scaled) and the slab's W
  auto load_slab = [&](int slab) {
    const int stage = slab % kStages, k0 = slab * kSlab;
    float* gi = ring + stage * kStageFloats;
    stage_block(gi, Gb + (size_t)k0 * n + i0, n, kSlab, kTile, m - k0,
                n - i0, vec);
    stage_block(gi + kStripFloats, Gb + (size_t)k0 * n + j0, n, kSlab,
                kTile, m - k0, n - j0, vec);
    if (threadIdx.x < kSlab) {
      const int k = k0 + threadIdx.x;
      float wk = 0.f;
      if (k < m)
        wk = W != nullptr ? W[woff + k]
                          : clip(lam[woff + k] / s[woff + k], w_lo, w_hi);
      w_ring[stage * kSlab + threadIdx.x] = wk;
    }
  };
  // g_ki * w_k in place on the first strip.  A thread scales the pieces it
  // copied itself (the chunks of stage_block), which its own cp_async_wait
  // covers; the block's barrier before the slab is used shows them to all.
  auto scale_slab = [&](int slab) {
    const int stage = slab % kStages;
    float* gi = ring + stage * kStageFloats;
    const float* wv = w_ring + stage * kSlab;
    for (int e = threadIdx.x; e < kSlab * (kTile / 4); e += kGemmThreads) {
      const int r = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
      const float wk = wv[r];
      float4 v = ld4(gi + r * kTile + c);
      v.x *= wk; v.y *= wk; v.z *= wk; v.w *= wk;
      st4(gi + r * kTile + c, v);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nslab) load_slab(t);
    cp_async_commit();
  }
  __syncthreads();   // the slabs' W, written by the first threads
  cp_async_wait<kStages - 2>();
  scale_slab(0);
  for (int t = 0; t < nslab; ++t) {
    // this thread's pieces of slab t + 1 have landed: scale them
    cp_async_wait<kStages - 3>();
    if (t + 1 < nslab) scale_slab(t + 1);
    // slab t, scaled, is visible to all; every thread is past slab t - 1,
    // whose stage the next load overwrites
    __syncthreads();
    if (t + kStages - 1 < nslab) load_slab(t + kStages - 1);
    cp_async_commit();
    const float* gi = ring + (t % kStages) * kStageFloats;
    if (diag) gtwg_slab<true>(acc, gi, gi + kStripFloats, tx, ty);
    else gtwg_slab<false>(acc, gi, gi + kStripFloats, tx, ty);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the mirror staging

  // entries with j >= i from registers; all of them transposed into shared
  // memory for the mirrored store
  float* mirror = smem;
  const size_t hoff = (size_t)b * n * n;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int il = tile_index(ty, r), i = i0 + il;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      mirror[tile_index(tx, c) * kMirrorStride + il] = acc[r][c];
    if (i >= n) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + half * 64 + tx * 4;
      const size_t o = hoff + (size_t)i * n + j;
      if (vec && j < n && j >= i) {
        const float4 h4 = ld4(H + o);
        float4 v = make_float4(acc[r][half * 4 + 0] + h4.x,
                               acc[r][half * 4 + 1] + h4.y,
                               acc[r][half * 4 + 2] + h4.z,
                               acc[r][half * 4 + 3] + h4.w);
        if (i == j) v.x += reg;
        st4(out + o, v);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (j + c < n && j + c >= i) {
            float v = acc[r][half * 4 + c] + H[o + c];
            if (i == j + c) v += reg;
            out[o + c] = v;
          }
        }
      }
    }
  }
  __syncthreads();
  // the mirrored places, strictly below the diagonal: row j0 + jl of the
  // output takes row jl of the staging, consecutive threads consecutive i
  for (int e = threadIdx.x; e < kTile * kTile; e += kGemmThreads) {
    const int jl = e / kTile, il = e % kTile;
    const int j = j0 + jl, i = i0 + il;
    if (j < n && i < j) {
      const size_t o = hoff + (size_t)j * n + i;
      out[o] = mirror[jl * kMirrorStride + il] + H[o];
    }
  }
}

// C[b] = alpha * A[b] @ B[b] + diag * I, all [n, n] row-major.  The same
// tile, register blocking and staging ring as gtwg_kernel, without the
// symmetry (the product is not symmetric).  A's tile is staged as it lies,
// [128 rows][16 k]: a thread reads four k of one row with one 16-byte load.
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
            float* __restrict__ C, int n, float alpha, float diag, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t off = (size_t)b * n * n;
  const float* Ab = A + off;
  const float* Bb = Bm + off;
  const int nslab = (n + kSlab - 1) / kSlab;

  auto load_slab = [&](int slab) {
    const int stage = slab % kStages, k0 = slab * kSlab;
    float* a_s = smem + stage * kStageFloats;   // a_s[ii][kk]
    stage_block(a_s, Ab + (size_t)i0 * n + k0, n, kTile, kSlab, n - i0,
                n - k0, vec);
    stage_block(a_s + kStripFloats, Bb + (size_t)k0 * n + j0, n, kSlab,
                kTile, n - k0, n - j0, vec);   // b_s[kk][jj]
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nslab) load_slab(t);
    cp_async_commit();
  }
  for (int t = 0; t < nslab; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < nslab) load_slab(t + kStages - 1);
    cp_async_commit();
    const float* a_s = smem + (t % kStages) * kStageFloats;
    const float* b_s = a_s + kStripFloats;
#pragma unroll
    for (int kq = 0; kq < kSlab; kq += 4) {
      float4 av[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        av[r] = ld4(a_s + tile_index(ty, r) * kSlab + kq);
#pragma unroll
      for (int t4 = 0; t4 < 4; ++t4) {
        float a[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          a[r] = t4 == 0 ? av[r].x : t4 == 1 ? av[r].y
               : t4 == 2 ? av[r].z : av[r].w;
        const float4 a0 = make_float4(a[0], a[1], a[2], a[3]);
        const float4 a1 = make_float4(a[4], a[5], a[6], a[7]);
        const int kk = kq + t4;
        const float4 b0 = ld4(b_s + kk * kTile + tx * 4);
        const float4 b1 = ld4(b_s + kk * kTile + 64 + tx * 4);
        outer4(acc, 0, 0, a0, b0);
        outer4(acc, 0, 1, a0, b1);
        outer4(acc, 1, 0, a1, b0);
        outer4(acc, 1, 1, a1, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + tile_index(ty, r);
    if (i >= n) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + half * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = alpha * acc[r][half * 4 + c];
        if (i == j + c) v[c] += diag;
      }
      float* o = C + off + (size_t)i * n + j;
      if (vec && j < n) {
        st4(o, make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < n) o[c] = v[c];
      }
    }
  }
}

constexpr size_t kGemmSmemBytes = kGemmSmemFloats * sizeof(float);

}  // namespace bggt

// vec != 0: n % 4 == 0 and every operand 16-byte aligned (the caller checks)
BGGT_API int bggt_gtwg(const float* H, const float* G, const float* W,
                       const float* lam, const float* s, float* out, int B,
                       int m, int n, float reg, float w_lo, float w_hi,
                       int vec, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bggt::gtwg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bggt::kGemmSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int t = (n + bggt::kTile - 1) / bggt::kTile;
  dim3 grid(t * (t + 1) / 2, 1, B);
  bggt::gtwg_kernel<<<grid, bggt::kGemmThreads, bggt::kGemmSmemBytes,
                      (cudaStream_t)stream>>>(H, G, W, lam, s, out, m, n, reg,
                                              w_lo, w_hi, vec);
  return (int)cudaGetLastError();
}

BGGT_API int bggt_gemm(const float* A, const float* Bm, float* C, int B,
                       int n, float alpha, float diag, int vec,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bggt::gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bggt::kGemmSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int t = (n + bggt::kTile - 1) / bggt::kTile;
  dim3 grid(t, t, B);
  bggt::gemm_kernel<<<grid, bggt::kGemmThreads, bggt::kGemmSmemBytes,
                      (cudaStream_t)stream>>>(A, Bm, C, n, alpha, diag, vec);
  return (int)cudaGetLastError();
}

BGGT_API const char* bggt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
