// ipm_iter: the body of one fused Mehrotra predictor-corrector sweep, one
// block per problem.
//
// Replaces bilevel_gait_gen_tpu/ops/pallas_kernels.py::ipm_iter, whose body
// is pdip._iteration_math with the unrolled p x p Cholesky
// (pallas_kernels._chol_inverse_unrolled).  The TPU kernel keeps a whole
// problem in VMEM; on Hopper M alone (256 x 256 f32 = 256 KB at the main
// path's shape) exceeds a block's 227 KB of shared memory and G is 1.25 MB,
// so the sweep is a chain on the caller's stream, driven by the wrapper
// ops/kernels.py::ipm_iter: gtwg.cu forms M (with W = clip(lam / s)), the
// GEMM of gtwg.cu applies the Newton-Schulz refresh when asked, and this
// kernel runs the rest of the iteration.  n and m are multiples of 128
// there (the caller pads), so rows move as 16-byte pieces.
//
// Bound: device-memory traffic.  Per problem and sweep the kernel streams G
// five times, Mi nine times, M twice and H once (~9 MB at n = 256,
// m = 1280) against ~3 MFLOP, and at 512 problems neither G (671 MB) nor M,
// Mi and H (134 MB each) stay in the 50 MB L2.  What the design does about
// it:
//  * vectors of length n, m and p live in shared memory (~107 KB at the
//    main path's shape); matrices are streamed from global memory and
//    never staged;
//  * two blocks of 512 threads on an SM: the launch bounds hold the kernel
//    to 64 registers a thread (512 threads at 128 registers take the whole
//    register file, and one block alone leaves the memory idle while it
//    factorizes or reduces), so one block's serial stretches run under the
//    other's passes;
//  * a matrix pass keeps kRows rows (2 KB) of every warp in flight, so an
//    SM has ~64 KB of loads outstanding (row-wise products with 4-byte
//    loads in the plain version's order of summation, see mv_rows; the
//    column-wise ones and the pass below with 16-byte loads);
//  * A Mi for the Schur complement takes four rows of Mi a step against
//    16-byte loads of A from shared memory: one shared load for four FFMA;
//  * the residuals' G^T lam and G x share one pass over G (each row: a dot
//    with x and an update of the column sums), five passes a sweep instead
//    of six; the predictor's and the corrector's passes depend on each
//    other and stay apart;
//  * the p x p Schur complement is factorized by one warp, and every
//    reduction has a fixed order (shuffle trees within a warp, partial sums
//    combined in index order), so a result does not change from run to run.
// The TPU kernel takes any number p of equality rows.  The block keeps A,
// A Mi and four p x p matrices in shared memory only up to p = 32 (at
// p = 256, the centroidal QP's, they would take ~2.2 MB), so for p > 32 the
// wrapper runs the Schur stage on the stream first (A Mi and (A Mi) A^T by
// gtwg.cu's gemm_kernel, S^-1 by chol_inverse.cu) and launches
// ipm_iter_handed_kernel, which reads A, the stage's A Mi and S^-1 from
// device memory and keeps only the vectors in shared memory (~130 KB at
// n = 512, m = 1792, p = 256: one block an SM).  Its bound is the same
// device-memory traffic, so it moves fewer bytes than the resident form's
// order of passes would (~32 MB a problem and sweep at that shape, from
// ~39 MB in its first version; reading each matrix once would be 7.7 MB):
//  * a KKT solve uses the A Mi of the Schur stage: A (Mi r) becomes
//    (A Mi) r, read in the same pass as Mi r (one pass over [Mi; A Mi]),
//    and Mi (A^T dy) becomes (A Mi)^T dy, so a solve reads Mi once and A
//    not at all (Mi twice and A twice before);
//  * the passes over A that share their vectors are one pass: A^T y with
//    A x in the residuals, A^T dy with A dx in each refinement (the pass
//    over G of the residuals, applied to A).
// Only the association changes ((A Mi) r for A (Mi r)), and the order of
// summation inside those rows; the p <= 32 kernel is the same code as
// before, instantiated without the handed inverse.
// The math and its order of operations follow _iteration_math line by line
// (only the order inside a row's dot product is the kernel's own),
// including where-selects (never a 0/1 multiply) and the absence of a
// non-finite guard on the Newton-Schulz refresh, which the TPU kernel also
// lacks.
#include "common.cuh"

namespace bggt {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 32;
constexpr int kRows = 2;     // rows a warp keeps in flight in a matrix pass
constexpr int kSuper = 256;  // columns a lane covers with two 16-byte loads

struct IpmArgs {
  const float *H, *q, *A, *b, *G, *h, *ga, *M, *Mi;
  const float* Si;  // S^-1 [B, p, p] of the Schur stage, or null (p <= 32)
  const float* AMi;  // A Mi [B, p, n] of the Schur stage, or null (p <= 32)
  float *x, *y, *lam, *s, *bx, *by, *blam, *bs, *bmerit;
  int *done, *it;
  int n, m, p, refine_steps;
  float reg_s;      // max(reg, 1e-7), the Schur complement's Tikhonov term
  float tol;
  float tol_r;      // 1e3 * tol
  float w_lo, w_hi;  // W = clip(lam / s, w_lo, w_hi)
  float eps;        // float32 machine epsilon
};

// Shared-memory layout of one problem (floats).  Everything up to and
// including `scratch` starts on a 16-byte boundary (n and m are multiples
// of 128, the p-vectors are padded to multiples of 4).
struct Vecs {
  float *x, *q, *rd, *r1, *dx, *e1, *t1, *t2, *dxc, *cx;            // n
  float *lam, *s, *h, *ga, *W, *rg, *rhs, *dsa, *dla, *ds, *dl, *tm;  // m
  float *y, *b, *rp, *r2, *dy, *e2, *tp, *cy, *dyc;                 // p
  float *A;                                                          // p*n
  // partial sums of the matrix passes; A Mi lives here while the Schur
  // complement is formed, before the first of those passes
  float *scratch, *AMi;                             // max(p*n, kWarps*kSuper)
  float *S, *U, *X, *Si;                                             // p*p
  float *red;                                                        // 64
};

inline size_t scratch_floats(int n, int p) {
  const size_t a = (size_t)p * n, b = (size_t)kWarps * kSuper;
  return a > b ? a : b;
}

inline size_t smem_floats(int n, int m, int p) {
  const size_t pp = (size_t)(p + 3) / 4 * 4;
  return (size_t)10 * n + 12 * (size_t)m + 9 * pp + (size_t)p * n +
         scratch_floats(n, p) + 4 * (size_t)p * p + 64;
}

// The layout when the Schur stage has run before the kernel (p > 32): A and
// S^-1 stay in device memory, and neither A Mi nor the factorization's
// matrices take room; the scratch is that of the matrix passes alone.
inline size_t smem_floats_handed(int n, int m, int p) {
  const size_t pp = (size_t)(p + 3) / 4 * 4;
  return (size_t)10 * n + 12 * (size_t)m + 9 * pp +
         (size_t)kWarps * kSuper + 64;
}

__device__ inline Vecs carve(float* base, int n, int m, int p) {
  Vecs v;
  float* c = base;
  float** nv[] = {&v.x, &v.q, &v.rd, &v.r1, &v.dx, &v.e1, &v.t1, &v.t2,
                  &v.dxc, &v.cx};
  for (float** f : nv) { *f = c; c += n; }
  float** mv[] = {&v.lam, &v.s, &v.h, &v.ga, &v.W, &v.rg, &v.rhs, &v.dsa,
                  &v.dla, &v.ds, &v.dl, &v.tm};
  for (float** f : mv) { *f = c; c += m; }
  float** pv[] = {&v.y, &v.b, &v.rp, &v.r2, &v.dy, &v.e2, &v.tp, &v.cy,
                  &v.dyc};
  for (float** f : pv) { *f = c; c += (p + 3) / 4 * 4; }
  v.A = c; c += (size_t)p * n;
  v.scratch = v.AMi = c;
  c += (size_t)p * n > (size_t)kWarps * kSuper ? (size_t)p * n
                                               : (size_t)kWarps * kSuper;
  v.S = c; c += p * p;
  v.U = c; c += p * p;
  v.X = c; c += p * p;
  v.Si = c; c += p * p;
  v.red = c;
  return v;
}

__device__ inline Vecs carve_handed(float* base, int n, int m, int p,
                                    const float* A, const float* AMi,
                                    const float* Si) {
  Vecs v;
  float* c = base;
  float** nv[] = {&v.x, &v.q, &v.rd, &v.r1, &v.dx, &v.e1, &v.t1, &v.t2,
                  &v.dxc, &v.cx};
  for (float** f : nv) { *f = c; c += n; }
  float** mv[] = {&v.lam, &v.s, &v.h, &v.ga, &v.W, &v.rg, &v.rhs, &v.dsa,
                  &v.dla, &v.ds, &v.dl, &v.tm};
  for (float** f : mv) { *f = c; c += m; }
  float** pv[] = {&v.y, &v.b, &v.rp, &v.r2, &v.dy, &v.e2, &v.tp, &v.cy,
                  &v.dyc};
  for (float** f : pv) { *f = c; c += (p + 3) / 4 * 4; }
  v.A = const_cast<float*>(A);
  v.Si = const_cast<float*>(Si);
  v.AMi = const_cast<float*>(AMi);
  v.S = v.U = v.X = nullptr;
  v.scratch = c; c += (size_t)kWarps * kSuper;
  v.red = c;
  return v;
}

// ---- block reductions (all threads call; result returned to all) ---------

__device__ inline float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? red[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

__device__ inline float block_min(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? red[lane] : __int_as_float(0x7f800000);
    w = warp_min(w);
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

__device__ inline float block_max(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? red[lane] : __int_as_float(0xff800000);
    w = warp_max(w);
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

// max |v[i]| over i < len (NaN propagates, as jnp.max does)
__device__ inline float amax_abs(const float* v, int len, float* red) {
  float a = __int_as_float(0xff800000);
  for (int i = threadIdx.x; i < len; i += kThreads) a = nan_max(a, fabsf(v[i]));
  return block_max(a, red);
}

// 1.0 if every v[i] (i < len) is finite, else 0.0
__device__ inline float all_finite(const float* v, int len, float* red) {
  float ok = 1.f;
  for (int i = threadIdx.x; i < len; i += kThreads)
    if (!isfinite(v[i])) ok = 0.f;
  return block_min(ok, red);
}

// ---- matrix-vector products (all threads call; output visible on return) -

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// out[r] = sum_c Mat[r * C + c] * v[c], r < R.  A warp takes kRows rows at a
// time; a lane sums the columns lane, lane + 32, ... of each in order (4
// bytes a load, a warp on 128 consecutive bytes), the loads of all kRows
// rows started ahead of the arithmetic, then a shuffle tree.  16-byte loads
// were tried and were no faster on the card, and they change the order of
// the sum: this one is the order of the plain version's matrix-vector
// products on the card, which keeps the ill-conditioned cold sweeps as
// close to the plain version as float32 allows.
__device__ void mv_rows(const float* Mat, int R, int C, const float* v,
                        float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r0 = warp * kRows; r0 < R; r0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
#pragma unroll 8
    for (int c = lane; c < C; c += 32) {
      const float xv = v[c];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < R)
          acc[j] = fmaf(Mat[(size_t)(r0 + j) * C + c], xv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float d = warp_sum(acc[j]);
      if (lane == 0 && r0 + j < R) out[r0 + j] = d;
    }
  }
  __syncthreads();
}

// mv_rows over the rows of Mat1 [R1, C] and then of Mat2 [R2, C] in one
// pass (the same order of summation in each row): out1 = Mat1 v,
// out2 = Mat2 v.
__device__ void mv_rows_pair(const float* Mat1, int R1, const float* Mat2,
                             int R2, int C, const float* v, float* out1,
                             float* out2) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int R = R1 + R2;
  for (int r0 = warp * kRows; r0 < R; r0 += kWarps * kRows) {
    const float* row[kRows];
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j;
      row[j] = r < R1 ? Mat1 + (size_t)r * C : Mat2 + (size_t)(r - R1) * C;
      acc[j] = 0.f;
    }
#pragma unroll 8
    for (int c = lane; c < C; c += 32) {
      const float xv = v[c];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < R) acc[j] = fmaf(row[j][c], xv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float d = warp_sum(acc[j]);
      const int r = r0 + j;
      if (lane == 0 && r < R) {
        if (r < R1) out1[r] = d;
        else out2[r - R1] = d;
      }
    }
  }
  __syncthreads();
}

// out[c] = sum_r v[r] * Mat[r * C + c], c < C, C a multiple of 128 and at
// most 128 * kWarps: a warp covers 128 columns (16 bytes a lane), the rows
// are dealt round robin to the warps of a column group, and the partial
// sums are combined in part order.  scratch: kWarps * 128 floats.
__device__ void vtm(const float* v, const float* Mat, int R, int C,
                    float* out, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int groups = C / 128, parts = kWarps / groups;
  if (warp < groups * parts) {
    const int part = warp / groups;
    const int c = (warp % groups) * 128 + lane * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int r = part; r < R; r += parts)
      axpy4(v[r], ld4(Mat + (size_t)r * C + c), acc);
    st4(scratch + part * C + c, acc);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc = scratch[c];
    for (int part = 1; part < parts; ++part) acc += scratch[part * C + c];
    out[c] = acc;
  }
  __syncthreads();
}

// One pass over G [m, n] for both residual products: gx[r] = G[r, :] . x
// and gtl[c] = sum_r lam[r] G[r, c].  A warp takes kRows rows at a time and
// up to kSuper columns (two 16-byte loads a lane) of each; the column sums
// are kept per warp over its rows in order and combined in warp order.
// n a multiple of 128; scratch: kWarps * kSuper floats.
__device__ void g_residual_pass(const float* G, int m, int n, const float* x,
                                const float* lam, float* gx, float* gtl,
                                float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cs = 0; cs < n; cs += kSuper) {
    const int c0 = cs + lane * 4, c1 = c0 + 128;
    const bool two = cs + 128 < n;
    const float4 x0 = ld4(x + c0);
    const float4 x1 = two ? ld4(x + c1) : zero;
    float4 s0 = zero, s1 = zero;
    for (int r0 = warp * kRows; r0 < m; r0 += kWarps * kRows) {
      float4 g0[kRows], g1[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const bool in = r0 + j < m;
        const float* row = G + (size_t)(r0 + j) * n;
        g0[j] = in ? ld4(row + c0) : zero;
        g1[j] = in && two ? ld4(row + c1) : zero;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const bool in = r0 + j < m;
        const float d = warp_sum(dot4(g1[j], x1, dot4(g0[j], x0, 0.f)));
        if (lane == 0 && in) gx[r0 + j] = cs == 0 ? d : gx[r0 + j] + d;
        const float l = in ? lam[r0 + j] : 0.f;
        axpy4(l, g0[j], s0);
        axpy4(l, g1[j], s1);
      }
    }
    st4(scratch + warp * kSuper + lane * 4, s0);
    st4(scratch + warp * kSuper + 128 + lane * 4, s1);
    __syncthreads();
    const int width = n - cs < kSuper ? n - cs : kSuper;
    for (int c = threadIdx.x; c < width; c += kThreads) {
      float acc = scratch[c];
      for (int w = 1; w < kWarps; ++w) acc += scratch[w * kSuper + c];
      gtl[cs + c] = acc;
    }
    __syncthreads();
  }
}

// AMi[i * n + c] = sum_k A[i * n + k] * Mi[k * n + c], i < p <= kP: one pass
// over Mi, a lane per column with kP accumulators, four rows of Mi a step
// against 16-byte loads of A from shared memory (one load of A for four
// FFMA).  Where the 32-column strips are fewer than the warps, the rows of
// Mi are split into contiguous parts over the spare warps and the parts'
// sums are added in part order.  n a multiple of 128.
template <int kP>
__device__ void a_times_mi(const float* A, const float* Mi, int p, int n,
                           float* AMi) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nstrips = n / 32;
  const int wps = nstrips >= kWarps ? 1 : kWarps / nstrips;
  const int per_round = wps == 1 ? kWarps : nstrips;   // strips per round
  const int klen = n / wps;
  for (int base = 0; base < nstrips; base += per_round) {
    const int st = base + warp % per_round, part = warp / per_round;
    const int c = st * 32 + lane;
    const bool active = part < wps && st < nstrips;
    float acc[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) acc[i] = 0.f;
    if (active) {
#pragma unroll 2
      for (int k = part * klen; k < (part + 1) * klen; k += 4) {
        float mi[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) mi[t] = Mi[(size_t)(k + t) * n + c];
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          if (i < p) {
            const float4 a4 = ld4(A + i * n + k);
            acc[i] = fmaf(a4.x, mi[0], acc[i]);
            acc[i] = fmaf(a4.y, mi[1], acc[i]);
            acc[i] = fmaf(a4.z, mi[2], acc[i]);
            acc[i] = fmaf(a4.w, mi[3], acc[i]);
          }
        }
      }
    }
    for (int turn = 0; turn < wps; ++turn) {
      if (active && part == turn) {
#pragma unroll
        for (int i = 0; i < kP; ++i)
          if (i < p)
            AMi[i * n + c] = turn == 0 ? acc[i] : AMi[i * n + c] + acc[i];
      }
      __syncthreads();
    }
  }
}

// Explicit inverse of the p x p SPD matrix S (overwritten) by the unrolled
// Cholesky of pallas_kernels._chol_inverse_unrolled; one warp.
__device__ void chol_inverse_unrolled(float* S, float* U, float* X, float* Si,
                                      int p) {
  const int lane = threadIdx.x % 32;
  for (int k = 0; k < p; ++k) {
    const float piv = nan_max(S[k * p + k], 1e-30f);
    const float rs = 1.0f / sqrtf(piv);
    for (int j = lane; j < p; j += 32)
      U[k * p + j] = j >= k ? S[k * p + j] * rs : 0.f;
    __syncwarp();
    for (int e = lane; e < p * p; e += 32) {
      const int i = e / p, j = e % p;
      S[e] -= U[k * p + j] * U[k * p + i];
    }
    __syncwarp();
  }
  for (int e = lane; e < p * p; e += 32) X[e] = 0.f;
  __syncwarp();
  for (int k = p - 1; k >= 0; --k) {
    for (int j = lane; j < p; j += 32) {
      float acc = 0.f;
      for (int l = 0; l < p; ++l) acc = fmaf(U[k * p + l], X[l * p + j], acc);
      X[k * p + j] = ((j == k ? 1.f : 0.f) - acc) / U[k * p + k];
    }
    __syncwarp();
  }
  for (int e = lane; e < p * p; e += 32) {
    const int i = e / p, j = e % p;
    float acc = 0.f;
    for (int l = 0; l < p; ++l) acc = fmaf(X[i * p + l], X[j * p + l], acc);
    Si[e] = acc;
  }
  __syncwarp();
}

// [[M, A^T], [A, 0]] [dx, dy] = [r1, r2] given M^-1 and S^-1
// (pdip._kkt_solve); uses t1, t2, tp as temporaries, so r1, dx must not
// be one of them.  kHanded: with the Schur stage's A Mi (in v.AMi),
// A Mi r1 and Mi A^T dy = (A Mi)^T dy read it instead of A and Mi.
template <bool kHanded>
__device__ void kkt_solve(const IpmArgs& a, const float* Mi, Vecs& v,
                          const float* r1, const float* r2, float* dx,
                          float* dy) {
  const int n = a.n, p = a.p;
  if constexpr (kHanded) {
    mv_rows_pair(Mi, n, v.AMi, p, n, r1, v.t1, v.tp);  // Mi r1, A Mi r1
    for (int i = threadIdx.x; i < p; i += kThreads) v.tp[i] -= r2[i];
    __syncthreads();
    mv_rows(v.Si, p, p, v.tp, dy);
    vtm(dy, v.AMi, p, n, v.t2, v.scratch);       // (A Mi)^T dy
    for (int c = threadIdx.x; c < n; c += kThreads) dx[c] = v.t1[c] - v.t2[c];
    __syncthreads();
    return;
  }
  mv_rows(Mi, n, n, r1, v.t1);                 // Mi r1
  mv_rows(v.A, p, n, v.t1, v.tp);              // A Mi r1
  for (int i = threadIdx.x; i < p; i += kThreads) v.tp[i] -= r2[i];
  __syncthreads();
  mv_rows(v.Si, p, p, v.tp, dy);
  vtm(dy, v.A, p, n, v.t2, v.scratch);         // A^T dy
  mv_rows(Mi, n, n, v.t2, dx);                 // Mi A^T dy
  for (int c = threadIdx.x; c < n; c += kThreads) dx[c] = v.t1[c] - dx[c];
  __syncthreads();
}

// one search direction (the solve_dir closure of _iteration_math);
// ds_extra is ds_a * dl_a for the corrector, absent for the predictor
template <bool kHanded>
__device__ void solve_dir(const IpmArgs& a, const float* G, const float* M,
                          const float* Mi, Vecs& v, float sigma_mu,
                          bool corrector, float* dx, float* dy, float* ds,
                          float* dl) {
  const int n = a.n, m = a.m, p = a.p;
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const float extra = corrector ? v.dsa[k] * v.dla[k] : 0.f;
    const float rc = (sigma_mu - v.lam[k] * extra) / v.s[k];
    v.rhs[k] = rc;
    v.tm[k] = (rc - v.lam[k]) + v.W[k] * v.rg[k];
  }
  __syncthreads();
  vtm(v.tm, G, m, n, v.e1, v.scratch);
  for (int c = threadIdx.x; c < n; c += kThreads) v.r1[c] = -(v.rd[c] + v.e1[c]);
  for (int i = threadIdx.x; i < p; i += kThreads) v.r2[i] = -v.rp[i];
  __syncthreads();
  kkt_solve<kHanded>(a, Mi, v, v.r1, v.r2, dx, dy);
  for (int step = 0; step < a.refine_steps; ++step) {
    // e1 = r1 - (M dx + A^T dy); e2 = r2 - A dx
    mv_rows(M, n, n, dx, v.e1);
    if constexpr (kHanded) {
      g_residual_pass(v.A, p, n, dx, dy, v.e2, v.t2, v.scratch);
    } else {
      vtm(dy, v.A, p, n, v.t2, v.scratch);
      mv_rows(v.A, p, n, dx, v.e2);
    }
    for (int c = threadIdx.x; c < n; c += kThreads)
      v.e1[c] = v.r1[c] - (v.e1[c] + v.t2[c]);
    for (int i = threadIdx.x; i < p; i += kThreads) v.e2[i] = v.r2[i] - v.e2[i];
    __syncthreads();
    kkt_solve<kHanded>(a, Mi, v, v.e1, v.e2, v.cx, v.cy);
    for (int c = threadIdx.x; c < n; c += kThreads) dx[c] += v.cx[c];
    for (int i = threadIdx.x; i < p; i += kThreads) dy[i] += v.cy[i];
    __syncthreads();
  }
  mv_rows(G, m, n, dx, ds);              // G dx
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const float dsk = -v.rg[k] - ds[k];
    ds[k] = dsk;
    dl[k] = (v.rhs[k] - v.lam[k]) - v.W[k] * dsk;
  }
  __syncthreads();
}

// min(1, min_k (dv_k < 0 ? -v_k / dv_k : inf))
__device__ inline float max_step(const float* val, const float* dv, int m,
                                 float* red) {
  float r = __int_as_float(0x7f800000);
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const float d = dv[k];
    const float ratio = d < 0.f ? -val[k] / d : __int_as_float(0x7f800000);
    r = nan_min(r, ratio);
  }
  return nan_min(block_min(r, red), 1.f);
}

// The sweep of one problem.  kHanded: the Schur stage (gtwg.cu's
// gemm_kernel for A Mi and (A Mi) A^T, chol_inverse.cu for S^-1) has run
// on the stream before, and A and S^-1 are read from device memory (p > 32);
// else A lives in shared memory and the block forms and inverts S itself.
template <bool kHanded>
__device__ __forceinline__ void ipm_iter_body(const IpmArgs& a, float* smem) {
  const int n = a.n, m = a.m, p = a.p;
  const int pb = blockIdx.x;
  const float* Ag = a.A + (size_t)pb * p * n;
  Vecs v = kHanded ? carve_handed(smem, n, m, p, Ag,
                                  a.AMi + (size_t)pb * p * n,
                                  a.Si + (size_t)pb * p * p)
                   : carve(smem, n, m, p);
  const size_t on = (size_t)pb * n, om = (size_t)pb * m, op = (size_t)pb * p;
  const float* H = a.H + (size_t)pb * n * n;
  const float* G = a.G + (size_t)pb * m * n;
  const float* M = a.M + (size_t)pb * n * n;
  const float* Mi = a.Mi + (size_t)pb * n * n;
  // read before any thread can reach the writes at the end
  const bool done_in = a.done[pb] != 0;
  const float bmerit_in = a.bmerit[pb];

  for (int c = threadIdx.x; c < n; c += kThreads) {
    v.x[c] = a.x[on + c];
    v.q[c] = a.q[on + c];
  }
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const float lk = a.lam[om + k], sk = a.s[om + k];
    v.lam[k] = lk;
    v.s[k] = sk;
    v.h[k] = a.h[om + k];
    v.ga[k] = a.ga[om + k];
    v.W[k] = clip(lk / sk, a.w_lo, a.w_hi);
  }
  for (int i = threadIdx.x; i < p; i += kThreads) {
    v.y[i] = a.y[op + i];
    v.b[i] = a.b[op + i];
  }
  if (!kHanded)
    for (int e = threadIdx.x; e < p * n; e += kThreads) v.A[e] = Ag[e];
  __syncthreads();

  float gsum = 0.f;
  for (int k = threadIdx.x; k < m; k += kThreads) gsum += v.ga[k];
  const float m_act = fmaxf(block_sum(gsum, v.red), 1.f);

  // Schur complement S = (A Mi) A^T + reg_s I and its unrolled inverse
  if (!kHanded) {
    if (p <= 16) a_times_mi<16>(v.A, Mi, p, n, v.AMi);
    else a_times_mi<kMaxP>(v.A, Mi, p, n, v.AMi);
    {
      const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
      for (int pr = warp; pr < p * p; pr += kWarps) {
        const int i = pr / p, l = pr % p;
        float acc = 0.f;
        for (int c = lane; c < n; c += 32)
          acc = fmaf(v.AMi[i * n + c], v.A[l * n + c], acc);
        acc = warp_sum(acc);
        if (lane == 0) v.S[pr] = acc + (i == l ? a.reg_s : 0.f);
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) chol_inverse_unrolled(v.S, v.U, v.X, v.Si, p);
    __syncthreads();
  }

  // residuals: r_d = H x + q + A^T y + G^T lam, r_p = A x - b,
  // r_g = G x + s - h
  mv_rows(H, n, n, v.x, v.t1);
  if constexpr (kHanded)
    g_residual_pass(v.A, p, n, v.x, v.y, v.rp, v.t2, v.scratch);
  else
    vtm(v.y, v.A, p, n, v.t2, v.scratch);
  g_residual_pass(G, m, n, v.x, v.lam, v.rg, v.e1, v.scratch);
  for (int c = threadIdx.x; c < n; c += kThreads)
    v.rd[c] = ((v.t1[c] + v.q[c]) + v.t2[c]) + v.e1[c];
  if constexpr (!kHanded) mv_rows(v.A, p, n, v.x, v.rp);
  for (int i = threadIdx.x; i < p; i += kThreads) v.rp[i] -= v.b[i];
  for (int k = threadIdx.x; k < m; k += kThreads)
    v.rg[k] = (v.rg[k] + v.s[k]) - v.h[k];
  __syncthreads();
  float sl = 0.f;
  for (int k = threadIdx.x; k < m; k += kThreads) sl += v.s[k] * v.lam[k];
  const float mu = block_sum(sl, v.red) / m_act;

  // predictor (affine): only ds_a, dl_a are kept
  solve_dir<kHanded>(a, G, M, Mi, v, 0.f, false, v.dx, v.dy, v.dsa, v.dla);
  const float ap_a = max_step(v.s, v.dsa, m, v.red);
  const float ad_a = max_step(v.lam, v.dla, m, v.red);
  float sa = 0.f;
  for (int k = threadIdx.x; k < m; k += kThreads)
    sa += (v.s[k] + ap_a * v.dsa[k]) * (v.lam[k] + ad_a * v.dla[k]);
  const float mu_aff = block_sum(sa, v.red) / m_act;
  const float ratio = mu_aff / nan_max(mu, 1e-30f);
  const float sigma = clip(ratio * ratio * ratio, 0.f, 1.f);

  // corrector
  solve_dir<kHanded>(a, G, M, Mi, v, sigma * mu, true, v.dxc, v.dyc, v.ds,
                     v.dl);
  const float a_p = 0.99f * max_step(v.s, v.ds, m, v.red);
  const float a_d = 0.99f * max_step(v.lam, v.dl, m, v.red);

  const float scale = 1.f + amax_abs(v.q, n, v.red);
  const float mu_floor = (100.f * a.eps) * scale;
  const float rp_max = amax_abs(v.rp, p, v.red);
  const float rd_max = amax_abs(v.rd, n, v.red);
  const bool conv = (mu < nan_max(a.tol * scale, mu_floor)) &&
                    (rp_max < a.tol_r * scale) && (rd_max < a.tol_r * scale);
  const bool step_ok = all_finite(v.dxc, n, v.red) > 0.5f &&
                       all_finite(v.dyc, p, v.red) > 0.5f &&
                       all_finite(v.ds, m, v.red) > 0.5f &&
                       all_finite(v.dl, m, v.red) > 0.5f;
  const bool new_done = done_in || conv;
  const bool take = !(new_done || !step_ok);

  const float merit = (mu + rp_max / scale) + rd_max / scale;
  const bool improved = (merit < bmerit_in) && isfinite(merit);

  // writes: every thread has read what it needs from global memory
  if (improved) {
    for (int c = threadIdx.x; c < n; c += kThreads) a.bx[on + c] = v.x[c];
    for (int i = threadIdx.x; i < p; i += kThreads) a.by[op + i] = v.y[i];
    for (int k = threadIdx.x; k < m; k += kThreads) {
      a.blam[om + k] = v.lam[k];
      a.bs[om + k] = v.s[k];
    }
  }
  if (take) {
    for (int c = threadIdx.x; c < n; c += kThreads)
      a.x[on + c] = v.x[c] + a_p * v.dxc[c];
    for (int i = threadIdx.x; i < p; i += kThreads)
      a.y[op + i] = v.y[i] + a_d * v.dyc[i];
    for (int k = threadIdx.x; k < m; k += kThreads) {
      a.s[om + k] = nan_max(v.s[k] + a_p * v.ds[k], 1e-30f);
      a.lam[om + k] = nan_max(v.lam[k] + a_d * v.dl[k], 1e-30f);
    }
  }
  if (threadIdx.x == 0) {
    if (improved) a.bmerit[pb] = merit;
    a.done[pb] = new_done ? 1 : 0;
    a.it[pb] += new_done ? 0 : 1;
  }
}

__global__ void __launch_bounds__(kThreads, 2) ipm_iter_kernel(IpmArgs a) {
  extern __shared__ float smem[];
  ipm_iter_body<false>(a, smem);
}

// p > 32: one block of a problem on an SM (the vectors alone are ~130 KB at
// n = 512, m = 1792, p = 256), so the registers are not capped at 64
__global__ void __launch_bounds__(kThreads, 1)
ipm_iter_handed_kernel(IpmArgs a) {
  extern __shared__ float smem[];
  ipm_iter_body<true>(a, smem);
}

}  // namespace bggt

BGGT_API int bggt_ipm_iter(const float* H, const float* q, const float* A,
                           const float* b, const float* G, const float* h,
                           const float* g_active, const float* M,
                           const float* Mi, const float* Si,
                           const float* AMi, float* x,
                           float* y, float* lam,
                           float* s, float* bx, float* by, float* blam,
                           float* bs, float* bmerit, int* done, int* it,
                           int B, int n, int m, int p, float reg_s, float tol,
                           float tol_r, float w_lo, float w_hi, float eps,
                           int refine_steps, void* stream) {
  if (n % 128 != 0 || m % 128 != 0 || n > 128 * bggt::kWarps ||
      (Si == nullptr && p > bggt::kMaxP) ||
      ((Si == nullptr) != (AMi == nullptr)))
    return (int)cudaErrorInvalidValue;
  bggt::IpmArgs a{H, q, A, b, G, h, g_active, M, Mi, Si, AMi, x, y, lam, s,
                  bx, by, blam, bs, bmerit, done, it, n, m, p, refine_steps,
                  reg_s, tol, tol_r, w_lo, w_hi, eps};
  if (Si != nullptr) {
    const size_t bytes = bggt::smem_floats_handed(n, m, p) * sizeof(float);
    static const cudaError_t smem_rc =
        bggt::allow_max_dynamic_smem(bggt::ipm_iter_handed_kernel);
    if (smem_rc != cudaSuccess) return (int)smem_rc;
    bggt::ipm_iter_handed_kernel<<<B, bggt::kThreads, bytes,
                                   (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t bytes = bggt::smem_floats(n, m, p) * sizeof(float);
  static const cudaError_t smem_rc =
      bggt::allow_max_dynamic_smem(bggt::ipm_iter_kernel);
  if (smem_rc != cudaSuccess) return (int)smem_rc;
  bggt::ipm_iter_kernel<<<B, bggt::kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

BGGT_API int bggt_ipm_iter_smem_bytes(int n, int m, int p, int handed) {
  return (int)((handed ? bggt::smem_floats_handed(n, m, p)
                       : bggt::smem_floats(n, m, p)) * sizeof(float));
}
