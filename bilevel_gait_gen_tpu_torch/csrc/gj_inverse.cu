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
// The block width is 32 (one warp inverts a diagonal block, a lane per
// column), not the TPU's lane width: the width changes rounding, not the
// function, and the plain version takes it as a parameter.
//
// What bounds it on this card: 2 n^3 flop and 2 n^2 floats of traffic per
// matrix are far less than what a chain of n / kW dependent block steps
// costs, so the kernel is bound by the latency of what sits between two
// steps (the diagonal block's 32 dependent pivots, the barriers) and by how
// fast one SM can feed FP32 FFMA from its own memory (IEEE, no tensor cores,
// no TF32).  The TPU kernel keeps the whole matrix in VMEM; here:
//
//  * resident form: one block of 256 threads per matrix with the matrix in
//    the block's shared memory from its one load (cp.async) to its one
//    store.  It needs the matrix's real size: the caller passes n_valid,
//    meaning "rows and columns from n_valid on are those of a diagonal
//    matrix" (spd_inverse pads 232 to 256 with (1 + shift) I).  The leading
//    n_valid rows (rounded up to a multiple of 8) are inverted in shared
//    memory, with a last block that is narrower than kW; the tail's inverse
//    is written as the blocked form computes it on a decoupled diagonal
//    entry t: u = pinv (2 - t pinv), pinv = 1 / t.  Zeros multiply and add
//    exactly and the non-zero terms keep their order, so the result is the
//    padded computation's.  232 rows of 236 floats and three 32 x 32 blocks
//    are 231,296 of the 232,448 bytes a block may use; a larger matrix takes
//    the streaming form.
//  * streaming form (n = 256 does not fit): the matrix lives in the output
//    buffer in device memory / L2 and the two panels of a step are staged in
//    shared memory (80 KB at n = 256, two blocks per SM); the same code
//    otherwise.  A block loads its tile's 8 rows before it stores the
//    first, so that the loads' L2 latencies overlap.
//
// The wrapper picks the form by shape alone (ops/kernels.py::gj_form).
// 256 threads: 512 were no faster in the resident form (the update is bound
// by the SM's FFMA issue and shared-memory rate, not by latency) and slower
// in the streaming form (one block per SM); 1024 leave 64 registers a
// thread and spill the 8 x 8 tile.
//
// In both forms the panels are used where they lie (the row panel is
// replaced by Dinv @ rowP in place, the update skips row and column panel J,
// the column panel is overwritten last), the rank-kW update runs on 8 x 8
// register tiles fed by 16-byte loads (a row stride of 4 mod 8 floats keeps
// the strided 16-byte loads off each other's banks), the diagonal block is
// inverted by one warp with shuffles and no block barrier, and that warp
// applies step J's update to diagonal block J + 1 itself and inverts it
// while the other warps update the rest.  Three block barriers per block
// step.
#include "common.cuh"

namespace bggt {

constexpr int kW = 32;             // block width of the blocked form
constexpr int kGjThreads = 256;    // scalar form
constexpr int kBlkThreads = 256;   // blocked forms
constexpr int kBlkWarps = kBlkThreads / 32;
constexpr int kColLd = kW + 4;     // row length of the staged column panel
constexpr unsigned kFullWarp = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// Blocked forms.  A is the working matrix (row length ld, nvp rows and
// columns, nvp a multiple of 8), block J is rows and columns [lo, lo + wv),
// wv = min(kW, nvp - lo) a multiple of 8.
// ---------------------------------------------------------------------------

__host__ __device__ inline int gj_round8(int n) { return (n + 7) / 8 * 8; }

// The inverse of a decoupled diagonal entry t as the blocked form computes
// it: the scalar step, then the polish.
__device__ __forceinline__ float gj_tail_value(float t) {
  const float pinv = 1.0f / (fabsf(t) < 1e-30f ? 1e-30f : t);
  return __fmul_rn(pinv, 2.0f - __fmul_rn(t, pinv));
}

// One warp: Dinv = polished scalar-GJ inverse of D = A[J, J] (an identity
// tail where wv < kW).  Where Cp is given, the rank-kW update of the step
// before is still to be applied to the block, which the updating warps
// leave out: D = A[J, J] - Cp[J, :] @ Rp[:, J], summed as gj_rank_update
// sums it.  A lane holds a column of the block in registers; the pivot
// row's factor is the lane's own, the pivot column comes from lane j by
// shuffle.  Dsm keeps D for the polish.
__device__ void gj_invert_diag(const float* A, int ld, int lo, int wv,
                               const float* Cp, int ldc, const float* Rp,
                               int ldr, float* Dsm, float* Dinv) {
  const int c = threadIdx.x % 32;
  float a[kW], t[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    a[k] = 0.0f;
    t[k] = (Cp != nullptr && c < wv) ? Rp[(size_t)k * ldr + lo + c] : 0.0f;
  }
#pragma unroll 1
  for (int r0 = 0; r0 < kW; r0 += 8) {              // 8 rows a turn
#pragma unroll
    for (int i = 0; i < kW - 8; ++i) a[i] = a[i + 8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = r0 + q;
      float v = r == c ? 1.0f : 0.0f;
      if (r < wv && c < wv) v = A[(size_t)(lo + r) * ld + lo + c];
      if (Cp != nullptr && r < wv) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < kW; k += 4) {
          const float4 d = ld4(Cp + (size_t)(lo + r) * ldc + k);
          s = fmaf(d.x, t[k], s);
          s = fmaf(d.y, t[k + 1], s);
          s = fmaf(d.z, t[k + 2], s);
          s = fmaf(d.w, t[k + 3], s);
        }
        if (c < wv) v -= s;
      }
      a[kW - 8 + q] = v;
    }
  }
#pragma unroll
  for (int r = 0; r < kW; ++r) {
    Dsm[r * kW + c] = a[r];
    t[r] = 0.0f;
  }
  // The loop over the pivots stays rolled (unrolled, its 6,000 instructions
  // run once each and the warp waits on the instruction cache): the rows
  // rotate through the registers instead, a[0] being the pivot row j and
  // a[i] row (j + i) % kW.
#pragma unroll 1
  for (int j = 0; j < kW; ++j) {
    const float p = __shfl_sync(kFullWarp, a[0], j);
    const float pinv = 1.0f / (fabsf(p) < 1e-30f ? 1e-30f : p);
    const float rowb = (c == j ? 1.0f : a[0]) * pinv;
    // the pivot column becomes pinv (0 - colb) = 0 - colb pinv
    const float f = c == j ? pinv : rowb;
#pragma unroll
    for (int r = 1; r < kW; ++r) {
      const float colb = __shfl_sync(kFullWarp, a[r], j);
      a[r - 1] = __fsub_rn(c == j ? 0.0f : a[r], __fmul_rn(colb, f));
    }
    a[kW - 1] = rowb;
  }
  __syncwarp();
#pragma unroll 1
  for (int r0 = 0; r0 < kW; r0 += 8) {              // T = 2 I - D @ Dinv
#pragma unroll
    for (int i = 0; i < kW - 8; ++i) t[i] = t[i + 8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kW; k += 4) {
        const float4 d = ld4(Dsm + (r0 + q) * kW + k);
        s = fmaf(d.x, a[k], s);
        s = fmaf(d.y, a[k + 1], s);
        s = fmaf(d.z, a[k + 2], s);
        s = fmaf(d.w, a[k + 3], s);
      }
      t[kW - 8 + q] = (r0 + q == c ? 2.0f : 0.0f) - s;
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) Dinv[k * kW + c] = a[k];
  __syncwarp();
#pragma unroll 1
  for (int r0 = 0; r0 < kW; r0 += 8) {              // Dinv @ T, 8 rows a turn
    float s8[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kW; k += 4) {
        const float4 d = ld4(Dinv + (r0 + q) * kW + k);
        s = fmaf(d.x, t[k], s);
        s = fmaf(d.y, t[k + 1], s);
        s = fmaf(d.z, t[k + 2], s);
        s = fmaf(d.w, t[k + 3], s);
      }
      s8[q] = s;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 8; ++q) Dinv[(r0 + q) * kW + c] = s8[q];
  }
}

// Row panel in place: A[J, :] = Dinv @ (A[J, :] with block J := I).  A lane
// pair (same column, rows 0-15 and 16-31 of the result) sits in one warp, so
// a warp barrier separates its reads from its writes.  rowS, where given,
// gets a copy with row length nvp (the streaming form's staged panel).
__device__ void gj_row_panel(float* A, int ld, int nvp, int lo, int wv,
                             const float* Dinv, float* rowS) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cl = lane % 16, r0 = (lane / 16) * 16;
  for (int c0 = warp * 16; c0 < nvp; c0 += kBlkWarps * 16) {
    const int c = c0 + cl;
    const bool live = c < nvp;
    const bool in_j = c >= lo && c < lo + wv;
    float b[kW], acc[16];
#pragma unroll
    for (int k = 0; k < kW; ++k)
      b[k] = (!live || k >= wv) ? 0.0f
             : in_j ? (k == c - lo ? 1.0f : 0.0f)
                    : A[(size_t)(lo + k) * ld + c];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kW; k += 4) {
        const float4 d = ld4(Dinv + (r0 + r) * kW + k);
        s = fmaf(d.x, b[k], s);
        s = fmaf(d.y, b[k + 1], s);
        s = fmaf(d.z, b[k + 2], s);
        s = fmaf(d.w, b[k + 3], s);
      }
      acc[r] = s;
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (r0 + r >= wv) continue;
        A[(size_t)(lo + r0 + r) * ld + c] = acc[r];
        if (rowS != nullptr) rowS[(r0 + r) * nvp + c] = acc[r];
      }
    }
  }
}

// Rank-wv update of everything outside row and column panel J:
// A[i, j] -= sum_k Cp[i, k] Rp[k, j].  Cp is the column panel (row length
// ldc, indexed by the matrix row), Rp the row panel after gj_row_panel (row
// length ldr).  A warp owns 32 x 64 outputs, a thread 8 rows x 2 groups of 4
// columns; the rows of block J are left out of the enumeration.  By the
// warps from 1 on; the diagonal block that starts at nx (none if nx < 0) is
// left to warp 0 (gj_invert_diag).
__device__ void gj_rank_update(float* A, int ld, int nvp, int lo, int wv,
                               const float* Cp, int ldc, const float* Rp,
                               int ldr, int nx) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx = lane % 8, ty = lane / 8;
  const int nrem = nvp - wv;
  const int row_tiles = (nrem + 31) / 32, col_tiles = (nvp + 63) / 64;
  for (int t = warp - 1; t < row_tiles * col_tiles; t += kBlkWarps - 1) {
    const int l0 = (t / col_tiles) * 32 + ty * 8;   // row, block J left out
    const bool rows_live = l0 < nrem;
    const int i0 = !rows_live ? 0 : (l0 < lo ? l0 : l0 + wv);
    int jc[2];
    bool store[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = (t % col_tiles) * 64 + 32 * h + tx * 4;
      store[h] = rows_live && j < nvp && !(j >= lo && j < lo + wv) &&
                 !(nx >= 0 && i0 >= nx && i0 < nx + kW && j >= nx &&
                   j < nx + kW);
      jc[h] = min(j, nvp - 4);
    }
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
    const float* ap = Cp + (size_t)i0 * ldc;
    for (int k = 0; k < wv; k += 4) {
      float4 b[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[kk][h] = ld4(Rp + (size_t)(k + kk) * ldr + jc[h]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 a4 = ld4(ap + (size_t)r * ldc + k);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[r][4 * h] = fmaf(a[kk], b[kk][h].x, acc[r][4 * h]);
            acc[r][4 * h + 1] = fmaf(a[kk], b[kk][h].y, acc[r][4 * h + 1]);
            acc[r][4 * h + 2] = fmaf(a[kk], b[kk][h].z, acc[r][4 * h + 2]);
            acc[r][4 * h + 3] = fmaf(a[kk], b[kk][h].w, acc[r][4 * h + 3]);
          }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!store[h]) continue;
      float* p = A + (size_t)i0 * ld + jc[h];
      float4 v[8];                        // all loads before the first store
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = ld4(p + (size_t)r * ld);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        v[r].x -= acc[r][4 * h];
        v[r].y -= acc[r][4 * h + 1];
        v[r].z -= acc[r][4 * h + 2];
        v[r].w -= acc[r][4 * h + 3];
        st4(p + (size_t)r * ld, v[r]);
      }
    }
  }
}

// Column panel: A[i, J] = -(Cp[i, :] @ Dinv) for the
// rows i outside block J.  A lane pair (same row, columns 0-15 and 16-31 of
// the result) sits in one warp: where Cp is A itself, a warp barrier
// separates its reads from its writes.
__device__ void gj_col_panel(float* A, int ld, int nvp, int lo, int wv,
                             const float* Cp, int ldc, const float* Dinv) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rl = lane % 16, q0 = (lane / 16) * 16;
  const int nrem = nvp - wv;
  for (int l0 = warp * 16; l0 < nrem; l0 += kBlkWarps * 16) {
    const int l = l0 + rl;
    const bool live = l < nrem;
    const int i = !live ? 0 : (l < lo ? l : l + wv);
    float a[kW], acc[16];
#pragma unroll
    for (int k = 0; k < kW; k += 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live && k < wv) v = ld4(Cp + (size_t)i * ldc + k);
      a[k] = v.x, a[k + 1] = v.y, a[k + 2] = v.z, a[k + 3] = v.w;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
#pragma unroll
      for (int q = 0; q < 16; q += 4) {
        const float4 d = ld4(Dinv + k * kW + q0 + q);
        acc[q] = fmaf(a[k], d.x, acc[q]);
        acc[q + 1] = fmaf(a[k], d.y, acc[q + 1]);
        acc[q + 2] = fmaf(a[k], d.z, acc[q + 2]);
        acc[q + 3] = fmaf(a[k], d.w, acc[q + 3]);
      }
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < 16; q += 4)
        if (q0 + q < wv)
          st4(A + (size_t)i * ld + lo + q0 + q,
              make_float4(-acc[q], -acc[q + 1], -acc[q + 2], -acc[q + 3]));
    }
  }
}

// The block steps.  kResident: A is the matrix in shared memory and both
// panels are read where they lie; else A is the output buffer in device
// memory, rowS [kW][nvp] and colS [nvp][kColLd] are the staged panels.
// Dbuf holds D and two Dinv (this step's and the next one's).
template <bool kResident>
__device__ void gj_block_steps(float* A, int ld, int nvp, float* Dbuf,
                               float* rowS, float* colS) {
  const int tid = threadIdx.x, warp = tid / 32;
  float* Dsm = Dbuf;
  const float* Cp = kResident ? A : colS;           // column panel, + lo
  const float* Rp = kResident ? A : rowS;           // row panel, + lo * ld
  const int ldc = kResident ? ld : kColLd, ldr = kResident ? ld : nvp;
  if (warp == 0)
    gj_invert_diag(A, ld, 0, min(kW, nvp), nullptr, 0, nullptr, 0, Dsm,
                   Dbuf + kW * kW);
  __syncthreads();
  for (int lo = 0, step = 0; lo < nvp; lo += kW, ++step) {
    const int wv = min(kW, nvp - lo), nx = lo + kW;
    float* Dinv = Dbuf + (1 + step % 2) * kW * kW;
    float* Dnext = Dbuf + (2 - step % 2) * kW * kW;
    const float* Cj = kResident ? Cp + lo : Cp;
    const float* Rj = kResident ? Rp + (size_t)lo * ld : Rp;
    if (!kResident) {
      for (int e = tid; e < nvp * (kW / 4); e += kBlkThreads) {
        const int i = e / (kW / 4), k = (e % (kW / 4)) * 4;
        if (i >= lo && i < lo + wv) continue;         // never read
        st4(colS + i * kColLd + k, ld4(A + (size_t)i * ld + lo + k));
      }
    }
    gj_row_panel(A, ld, nvp, lo, wv, Dinv, kResident ? nullptr : rowS);
    __syncthreads();
    // warp 0 inverts the next diagonal block, the others update the rest
    if (warp != 0)
      gj_rank_update(A, ld, nvp, lo, wv, Cj, ldc, Rj, ldr,
                     nx < nvp ? nx : -1);
    else if (nx < nvp)
      gj_invert_diag(A, ld, nx, min(kW, nvp - nx), Cj, ldc, Rj, ldr, Dsm,
                     Dnext);
    __syncthreads();
    gj_col_panel(A, ld, nvp, lo, wv, Cj, ldc, Dinv);
    __syncthreads();
  }
}

// Resident form: n % 4 == 0, n_valid <= n, nvp = gj_round8(n_valid) <= n.
// Shared memory: A [nvp][nvp + 4], then D and two Dinv [kW][kW].
__global__ void __launch_bounds__(kBlkThreads, 1)
gj_resident_kernel(const float* __restrict__ M, float* __restrict__ out,
                   int n, int n_valid) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nvp = gj_round8(n_valid), ld = nvp + 4;
  float* A = smem;
  float* Dbuf = A + nvp * ld;
  const float* Min = M + (size_t)blockIdx.x * n * n;
  float* O = out + (size_t)blockIdx.x * n * n;
  for (int e = tid; e < nvp * (nvp / 4); e += kBlkThreads) {
    const int i = e / (nvp / 4), c = (e % (nvp / 4)) * 4;
    cp_async_16(A + i * ld + c, Min + (size_t)i * n + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  gj_block_steps<true>(A, ld, nvp, Dbuf, nullptr, nullptr);
  for (int e = tid; e < n * (n / 4); e += kBlkThreads) {
    const int i = e / (n / 4), c = (e % (n / 4)) * 4;
    float4 v;
    if (i < n_valid && c + 3 < n_valid) {
      v = ld4(A + i * ld + c);
    } else {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = (i < n_valid && c + q < n_valid) ? A[i * ld + c + q]
               : (i == c + q && i >= n_valid)
                   ? gj_tail_value(Min[(size_t)i * n + i])
                   : 0.0f;
      v = make_float4(w[0], w[1], w[2], w[3]);
    }
    st4(O + (size_t)i * n + c, v);
  }
}

// Streaming form: n % kW == 0.  Shared memory: D and two Dinv [kW][kW],
// the row panel [kW][n], the column panel [n][kColLd].
__global__ void __launch_bounds__(kBlkThreads, 2)
gj_streaming_kernel(const float* __restrict__ M, float* __restrict__ out,
                    int n) {
  extern __shared__ __align__(16) float smem[];
  float* Dbuf = smem;
  float* rowS = Dbuf + 3 * kW * kW;
  float* colS = rowS + kW * n;
  const float* Min = M + (size_t)blockIdx.x * n * n;
  float* A = out + (size_t)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * (n / 4); e += kBlkThreads)
    st4(A + (size_t)e * 4, ld4(Min + (size_t)e * 4));
  __syncthreads();
  gj_block_steps<false>(A, n, n, Dbuf, rowS, colS);
}

}  // namespace bggt

BGGT_API int bggt_gj_block_width() { return bggt::kW; }

// Bytes of dynamic shared memory of the resident form at n_valid (form 1)
// and of the streaming form at n (form 2).
BGGT_API int bggt_gj_smem_bytes(int form, int n) {
  const int w2 = bggt::kW * bggt::kW;
  if (form == 1) {
    const int nvp = bggt::gj_round8(n);
    return (int)sizeof(float) * (nvp * (nvp + 4) + 3 * w2);
  }
  return (int)sizeof(float) * (3 * w2 + bggt::kW * n + n * bggt::kColLd);
}

// out[b] = inv(M[b]) for B matrices [n, n] (both 16-byte aligned where a
// blocked form is asked for).  form 0: scalar form.  form 1: resident
// blocked form, the rows and columns from n_valid on being those of a
// diagonal matrix (n a multiple of the block width).  form 2: streaming
// blocked form (n a multiple of the block width; n_valid is not looked at).
BGGT_API int bggt_gj_inverse(const float* M, float* out, int B, int n,
                             int n_valid, int form, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 0) {
    const int smem = (int)sizeof(float) * 2 * n;
    bggt::gj_scalar_kernel<<<B, bggt::kGjThreads, smem, st>>>(M, out, n);
    return (int)cudaGetLastError();
  }
  if (n % bggt::kW != 0 || n_valid < 1 || n_valid > n ||
      (form != 1 && form != 2))
    return (int)cudaErrorInvalidValue;
  const int smem = bggt_gj_smem_bytes(form, form == 1 ? n_valid : n);
  if (form == 1) {
    static const cudaError_t smem_rc =
        bggt::allow_max_dynamic_smem(bggt::gj_resident_kernel);
    if (smem_rc != cudaSuccess) return (int)smem_rc;
    bggt::gj_resident_kernel<<<B, bggt::kBlkThreads, smem, st>>>(M, out, n,
                                                                n_valid);
  } else {
    static const cudaError_t smem_rc =
        bggt::allow_max_dynamic_smem(bggt::gj_streaming_kernel);
    if (smem_rc != cudaSuccess) return (int)smem_rc;
    bggt::gj_streaming_kernel<<<B, bggt::kBlkThreads, smem, st>>>(M, out, n);
  }
  return (int)cudaGetLastError();
}
