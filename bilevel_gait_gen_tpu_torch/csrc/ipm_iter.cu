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
// kernel runs the rest of the iteration.
//
// Bound: per problem and sweep the kernel streams G five times, Mi four
// times and M, H once each (~9 MB at n = 256, m = 1280), against ~3 MFLOP,
// so it is bound by memory traffic, most of it served from L2.  The simple
// design: vectors of length n, m and p live in shared memory, matrices are
// read from global memory by whole warps on consecutive addresses, the
// p x p Schur complement is factorized by one warp, and every reduction
// is a fixed-order block reduction.  The math and its order of operations
// follow _iteration_math line by line, including where-selects (never a
// 0/1 multiply) and the absence of a non-finite guard on the Newton-Schulz
// refresh, which the TPU kernel also lacks.
#include "common.cuh"

namespace bggt {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 32;

struct IpmArgs {
  const float *H, *q, *A, *b, *G, *h, *ga, *M, *Mi;
  float *x, *y, *lam, *s, *bx, *by, *blam, *bs, *bmerit;
  int *done, *it;
  int n, m, p, refine_steps;
  float reg_s;      // max(reg, 1e-7), the Schur complement's Tikhonov term
  float tol;
  float tol_r;      // 1e3 * tol
  float w_lo, w_hi;  // W = clip(lam / s, w_lo, w_hi)
  float eps;        // float32 machine epsilon
};

// Shared-memory layout of one problem (floats).
struct Vecs {
  float *x, *q, *rd, *r1, *dx, *e1, *t1, *t2, *dxc, *cx;            // n
  float *lam, *s, *h, *ga, *W, *rg, *rhs, *dsa, *dla, *ds, *dl, *tm;  // m
  float *y, *b, *rp, *r2, *dy, *e2, *tp, *cy, *dyc;                 // p
  float *A, *AMi;                                                    // p*n
  float *S, *U, *X, *Si;                                             // p*p
  float *scratch;                                                    // kThreads
  float *red;                                                        // 32
};

inline size_t smem_floats(int n, int m, int p) {
  return (size_t)10 * n + 12 * (size_t)m + 9 * (size_t)p +
         2 * (size_t)p * n + 4 * (size_t)p * p + kThreads + 32;
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
  for (float** f : pv) { *f = c; c += p; }
  v.A = c; c += (size_t)p * n;
  v.AMi = c; c += (size_t)p * n;
  v.S = c; c += p * p;
  v.U = c; c += p * p;
  v.X = c; c += p * p;
  v.Si = c; c += p * p;
  v.scratch = c; c += kThreads;
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

// out[r] = sum_c Mat[r * C + c] * v[c], r < R: one warp per row
__device__ void mv_rows(const float* Mat, int R, int C, const float* v,
                        float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < R; r += kWarps) {
    const float* row = Mat + (size_t)r * C;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) acc = fmaf(row[c], v[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
  __syncthreads();
}

// out[c] = sum_r v[r] * Mat[r * C + c], c < C: lanes on consecutive columns,
// rows split over the spare warps, partials combined in part order
__device__ void vtm(const float* v, const float* Mat, int R, int C,
                    float* out, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nstrips = (C + 31) / 32;
  if (nstrips >= kWarps) {
    for (int st = warp; st < nstrips; st += kWarps) {
      const int c = st * 32 + lane;
      if (c < C) {
        float acc = 0.f;
        for (int r = 0; r < R; ++r) acc = fmaf(v[r], Mat[(size_t)r * C + c], acc);
        out[c] = acc;
      }
    }
    __syncthreads();
    return;
  }
  const int wps = kWarps / nstrips;
  if (warp < nstrips * wps) {
    const int st = warp % nstrips, part = warp / nstrips;
    const int c = st * 32 + lane;
    if (c < C) {
      float acc = 0.f;
      for (int r = part; r < R; r += wps)
        acc = fmaf(v[r], Mat[(size_t)r * C + c], acc);
      scratch[part * C + c] = acc;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc = scratch[c];
    for (int part = 1; part < wps; ++part) acc += scratch[part * C + c];
    out[c] = acc;
  }
  __syncthreads();
}

// AMi[i * n + c] = sum_k A[i * n + k] * Mi[k * n + c]: one pass over Mi,
// p accumulators per lane
__device__ void a_times_mi(const float* A, const float* Mi, int p, int n,
                           float* AMi) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nstrips = (n + 31) / 32;
  const int wps = nstrips >= kWarps ? 1 : kWarps / nstrips;
  const int nparts_warps = nstrips >= kWarps ? kWarps : nstrips * wps;
  for (int pp = 0; pp < wps; ++pp) {
    if (warp < nparts_warps && warp / nstrips == pp) {
      for (int st = warp % nstrips; st < nstrips; st += (wps == 1 ? kWarps : nstrips)) {
        const int c = st * 32 + lane;
        float acc[kMaxP];
#pragma unroll
        for (int i = 0; i < kMaxP; ++i) acc[i] = 0.f;
        if (c < n) {
          for (int k = pp; k < n; k += wps) {
            const float mik = Mi[(size_t)k * n + c];
#pragma unroll
            for (int i = 0; i < kMaxP; ++i)
              if (i < p) acc[i] = fmaf(A[i * n + k], mik, acc[i]);
          }
#pragma unroll
          for (int i = 0; i < kMaxP; ++i)
            if (i < p) AMi[i * n + c] = pp == 0 ? acc[i] : AMi[i * n + c] + acc[i];
        }
      }
    }
    __syncthreads();
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
// be one of them
__device__ void kkt_solve(const IpmArgs& a, const float* Mi, Vecs& v,
                          const float* r1, const float* r2, float* dx,
                          float* dy) {
  const int n = a.n, p = a.p;
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
  kkt_solve(a, Mi, v, v.r1, v.r2, dx, dy);
  for (int step = 0; step < a.refine_steps; ++step) {
    // e1 = r1 - (M dx + A^T dy); e2 = r2 - A dx
    mv_rows(M, n, n, dx, v.e1);
    vtm(dy, v.A, p, n, v.t2, v.scratch);
    mv_rows(v.A, p, n, dx, v.e2);
    for (int c = threadIdx.x; c < n; c += kThreads)
      v.e1[c] = v.r1[c] - (v.e1[c] + v.t2[c]);
    for (int i = threadIdx.x; i < p; i += kThreads) v.e2[i] = v.r2[i] - v.e2[i];
    __syncthreads();
    kkt_solve(a, Mi, v, v.e1, v.e2, v.cx, v.cy);
    for (int c = threadIdx.x; c < n; c += kThreads) dx[c] += v.cx[c];
    for (int i = threadIdx.x; i < p; i += kThreads) dy[i] += v.cy[i];
    __syncthreads();
  }
  mv_rows(G, m, n, dx, ds);                    // G dx
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

__global__ void __launch_bounds__(kThreads) ipm_iter_kernel(IpmArgs a) {
  extern __shared__ float smem[];
  const int n = a.n, m = a.m, p = a.p;
  const int pb = blockIdx.x;
  Vecs v = carve(smem, n, m, p);
  const size_t on = (size_t)pb * n, om = (size_t)pb * m, op = (size_t)pb * p;
  const float* H = a.H + (size_t)pb * n * n;
  const float* G = a.G + (size_t)pb * m * n;
  const float* M = a.M + (size_t)pb * n * n;
  const float* Mi = a.Mi + (size_t)pb * n * n;
  const float* Ag = a.A + (size_t)pb * p * n;
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
  for (int e = threadIdx.x; e < p * n; e += kThreads) v.A[e] = Ag[e];
  __syncthreads();

  float gsum = 0.f;
  for (int k = threadIdx.x; k < m; k += kThreads) gsum += v.ga[k];
  const float m_act = fmaxf(block_sum(gsum, v.red), 1.f);

  // Schur complement S = (A Mi) A^T + reg_s I and its unrolled inverse
  a_times_mi(v.A, Mi, p, n, v.AMi);
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

  // residuals: r_d = H x + q + A^T y + G^T lam, r_p = A x - b,
  // r_g = G x + s - h
  mv_rows(H, n, n, v.x, v.t1);
  vtm(v.y, v.A, p, n, v.t2, v.scratch);
  vtm(v.lam, G, m, n, v.e1, v.scratch);
  for (int c = threadIdx.x; c < n; c += kThreads)
    v.rd[c] = ((v.t1[c] + v.q[c]) + v.t2[c]) + v.e1[c];
  mv_rows(v.A, p, n, v.x, v.rp);
  for (int i = threadIdx.x; i < p; i += kThreads) v.rp[i] -= v.b[i];
  mv_rows(G, m, n, v.x, v.rg);
  for (int k = threadIdx.x; k < m; k += kThreads)
    v.rg[k] = (v.rg[k] + v.s[k]) - v.h[k];
  __syncthreads();
  float sl = 0.f;
  for (int k = threadIdx.x; k < m; k += kThreads) sl += v.s[k] * v.lam[k];
  const float mu = block_sum(sl, v.red) / m_act;

  // predictor (affine): only ds_a, dl_a are kept
  solve_dir(a, G, M, Mi, v, 0.f, false, v.dx, v.dy, v.dsa, v.dla);
  const float ap_a = max_step(v.s, v.dsa, m, v.red);
  const float ad_a = max_step(v.lam, v.dla, m, v.red);
  float sa = 0.f;
  for (int k = threadIdx.x; k < m; k += kThreads)
    sa += (v.s[k] + ap_a * v.dsa[k]) * (v.lam[k] + ad_a * v.dla[k]);
  const float mu_aff = block_sum(sa, v.red) / m_act;
  const float ratio = mu_aff / nan_max(mu, 1e-30f);
  const float sigma = clip(ratio * ratio * ratio, 0.f, 1.f);

  // corrector
  solve_dir(a, G, M, Mi, v, sigma * mu, true, v.dxc, v.dyc, v.ds, v.dl);
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

}  // namespace bggt

BGGT_API int bggt_ipm_iter(const float* H, const float* q, const float* A,
                           const float* b, const float* G, const float* h,
                           const float* g_active, const float* M,
                           const float* Mi, float* x, float* y, float* lam,
                           float* s, float* bx, float* by, float* blam,
                           float* bs, float* bmerit, int* done, int* it,
                           int B, int n, int m, int p, float reg_s, float tol,
                           float tol_r, float w_lo, float w_hi, float eps,
                           int refine_steps, void* stream) {
  if (p > bggt::kMaxP) return (int)cudaErrorInvalidValue;
  const size_t bytes = bggt::smem_floats(n, m, p) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bggt::ipm_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  bggt::IpmArgs a{H, q, A, b, G, h, g_active, M, Mi, x, y, lam, s, bx, by,
                  blam, bs, bmerit, done, it, n, m, p, refine_steps,
                  reg_s, tol, tol_r, w_lo, w_hi, eps};
  bggt::ipm_iter_kernel<<<B, bggt::kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
