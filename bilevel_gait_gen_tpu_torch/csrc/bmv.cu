// bmv: batched dot products out[z, a, b] = sum_k X[z, a, k] * Y[z, b, k],
// float32 or float64, each entry summed in an order fixed by the reduction
// length K alone.
//
// The per-scenario products of utils/jnp_compat.py on the card (matvec:
// Y = v as one row; vecmat: X = M^T, a transposed view or a contiguous
// copy; matmul_nt: X Y^T).  cuBLAS's batched GEMV and small batched GEMM
// pick their kernel, and how they split a row's sum, by the batch count, so
// one scenario's bits changed with the number of scenarios beside it.  Here
// nothing of the launch enters an entry's arithmetic: the launch shape
// (bmv_plan) comes from (A, Bn, K, dtype) and the strides, never from the
// batch count, and it picks which threads compute an entry, never the order
// in which it is summed.
//
// The order (the contract; tests/test_torch_kernels_bmv.py holds the host
// build of this file to an exact rational model of it, bit for bit):
//  * K <= kSeqMax (32): one FMA chain over k ascending, acc = X_0 Y_0, then
//    acc = fma(X_k, Y_k, acc) for k = 1 .. K-1;
//  * K > kSeqMax: 32 lane chains; chain l runs the FMA chain over k = l,
//    l + 32, l + 64, ... ascending from its first product, then the 32
//    partial sums meet in a fixed xor butterfly: at offsets 16, 8, 4, 2, 1
//    the partial sum of lane l becomes p_l + p_(l^o), and lane 0's is the
//    entry.
// K = 0 gives 0.  Products and butterfly adds are the *_rn intrinsics,
// which the compiler never contracts into an FMA.
//
// Operands are addressed by strides (in elements): the batch index z is up
// to three broadcast axes (kMaxAxes) of sizes nz[0..2], X's and Y's batch
// strides per axis (0 where an operand is broadcast: one vector over many
// matrices, one [3, 3] matrix over a batch of vectors), then each operand's
// row and k strides, so a transposed or otherwise strided view is read in
// place.  The output is contiguous [Z, A, Bn].
//
// Bound: bytes.  Each entry reads K elements of X and of Y and does K
// multiply-adds, so the work is one pass over X (and over Y where it has
// more than one row) at a few hundred KB to tens of MB a call; a batch-1
// call, and every call of K <= 32 at the call sites, is one launch's
// latency.  The design:
//  * K > 32 (bmv_lane_body): a block takes a tile of zt scenarios x ta rows
//    of X x tb rows of Y and decomposes its batch indices once, in 32-bit
//    arithmetic, into a table of the staged rows' offsets in shared memory
//    (bmv_tile).  It stages those rows into shared memory a chunk of k at a
//    time (16-byte cp.async where the k stride is 1 and the rows are
//    16-byte aligned, a warp a row; else element copies), so a warp's loads
//    are coalesced and a staged row of Y serves every row of X of the tile
//    (the vector of a matvec is read once a tile, not once a row).  G = 4
//    .. 32 threads take an entry: thread j holds lane chains j, j + G, ...,
//    so the butterfly's offsets 16 .. G are adds inside the thread and
//    G/2 .. 1 shuffles; rows sit at a stride = G (mod 32), so the G-thread
//    groups of a warp read distinct banks.  A chunk of k is a multiple of
//    32 long, so the chains run on over chunks; no sum is split across
//    blocks.
//  * K <= 32 (bmv_seq_body): one thread an entry, the entries in order, a
//    thread's indices in 32-bit arithmetic, its row read straight from
//    device memory: no row but a matvec's vector is read by two threads
//    (L1 serves that).  Measured slower on an H100 at the call sites'
//    shapes (PERF.md): staging through shared memory by the block (+0.5-1 us a
//    launch); a warp staging its 32 rows of X with neighbouring lanes on
//    neighbouring elements (+1.2-3.3 us); all of a thread's terms loaded
//    before its chain (+0.8-1.9 us).
// No tensor cores (wgmma's order of summation is not ours to fix), no
// library call.
#include "common.cuh"

namespace bggt {

constexpr int kSeqMax = 32;
constexpr int kMaxAxes = 3;
constexpr int kMaxZt = 64;          // scenarios a block holds at most
// The launch shape's constants (bmv_plan), measured on an H100 at the
// call sites' shapes (PERF.md).  K > 32: the threads a block aims at for a
// matvec (Bn = 1) and where a staged row of Y serves more rows of X
// (Bn > 1); the terms of an entry's sum a thread aims at (which set G);
// the longest k chunk (a multiple of 32; a longer sum is staged in chunks
// of it, two buffers deep).  K <= 32: the threads (= entries) of a block.
constexpr int kBmvMvThreads = 128;
constexpr int kBmvThreads = 512;
constexpr int kBmvTerms = 64;
constexpr int kBmvChunk = 256;
constexpr int kBmvSeqThreads = 64;
// dynamic shared memory a block may use: under the 48 KB that needs no
// opt-in, less the static offsets
constexpr int kSmemBudget = 45 * 1024;

struct BmvArgs {
  const void* X;
  const void* Y;
  void* out;
  long long sx[kMaxAxes], sy[kMaxAxes];  // batch strides, outermost first
  long long sxa, sxk, syb, syk;          // row and k strides
  int nz[kMaxAxes];                      // batch sizes, outermost first
  int A, Bn, K, Z;
  // the launch shape (bmv_plan)
  int zt, ta, tb;          // scenarios, X rows, Y rows of a block's tile
  int tiles_b, tiles;      // tiles of Y rows, tiles of a scenario group
  int kc, rs;              // k chunk, row stride in shared memory
  int nt;                  // threads a block
  int vec_x, vec_y;        // stage by 16-byte cp.async
  int kp_log2;             // element copies: 2^kp_log2 columns a pass
  int n_seq;               // K <= 32: the entries, Z A Bn
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

constexpr int kMaxRows = 256;      // staged rows of X and Y a block holds

struct BmvTile {
  int z0, a0, b0;
  int n_slots;             // the block's scenarios that exist
};

// The block's tile from blockIdx.x, and the table of its staged rows'
// offsets into X (row_off[0 .. zt ta)) and Y (row_off[zt ta .. zt (ta +
// tb))), -1 for a row that does not exist: the one decomposition of the
// batch index, a row a thread.  The caller syncs before reading the table.
__device__ __forceinline__ BmvTile bmv_tile(const BmvArgs& a,
                                            long long* row_off) {
  BmvTile t;
  const int bx = (int)blockIdx.x;
  const int zg = bx / a.tiles;
  const int tile = bx - zg * a.tiles;
  const int ti = tile / a.tiles_b;
  t.a0 = ti * a.ta;
  t.b0 = (tile - ti * a.tiles_b) * a.tb;
  t.z0 = zg * a.zt;
  t.n_slots = min(a.zt, a.Z - t.z0);
  const int rx = a.zt * a.ta, rows = rx + a.zt * a.tb;
  for (int r = (int)threadIdx.x; r < rows; r += a.nt) {
    const bool is_x = r < rx;
    const int per = is_x ? a.ta : a.tb, rr = is_x ? r : r - rx;
    const int slot = a.zt == 1 ? 0 : rr / per;
    const int row = (is_x ? t.a0 : t.b0) + rr - slot * per;
    long long o = -1;
    if (slot < t.n_slots && row < (is_x ? a.A : a.Bn)) {
      int z = t.z0 + slot;
      o = row * (is_x ? a.sxa : a.syb);
      for (int ax = kMaxAxes - 1; ax >= 0 && z > 0; --ax) {
        const int n = a.nz[ax];
        if (n == 1) continue;
        const int q = z / n;
        o += (z - q * n) * (is_x ? a.sx[ax] : a.sy[ax]);
        z = q;
      }
    }
    row_off[r] = o;
  }
  return t;
}

// Columns [k0, k0 + kcl) of n_rows staged rows (offsets ro, -1 to skip)
// into s, row stride rs.  By cp.async a warp takes a row and its lanes the
// row's 16-byte pieces (left in flight: the caller commits them as a group
// and waits); element copies take 2^sh columns and nt >> sh rows a pass,
// kStageUnroll rows' loads in flight before their stores.
constexpr int kStageUnroll = 4;

template <class T>
__device__ __forceinline__ void bmv_stage(const T* __restrict__ g,
                                          const long long* ro, int n_rows,
                                          long long s_k, int k0, int kcl,
                                          int vec, int sh, T* s, int rs,
                                          int nt) {
  const int tid = (int)threadIdx.x;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int pc = kcl / V;            // 16-byte pieces a row
    for (int r = tid / 32; r < n_rows; r += nt / 32) {
      if (ro[r] < 0) continue;
      const T* src = g + ro[r] + k0;
      T* dst = s + r * rs;
      for (int p = tid % 32; p < pc; p += 32)
        cp_async_16(reinterpret_cast<float*>(dst + p * V),
                    reinterpret_cast<const float*>(src + p * V));
    }
    return;              // the caller commits and waits
  }
  const int step = nt >> sh;
  for (int rb = tid >> sh; rb < n_rows; rb += step * kStageUnroll) {
    for (int kk = tid & ((1 << sh) - 1); kk < kcl; kk += 1 << sh) {
      T v[kStageUnroll];
      int at[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int r = rb + u * step;
        at[u] = -1;
        if (r < n_rows && ro[r] >= 0) {
          v[u] = g[ro[r] + (k0 + kk) * s_k];
          at[u] = r * rs + kk;
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u)
        if (at[u] >= 0) s[at[u]] = v[u];
    }
  }
}

// Entry of thread group e in the tile: (slot, row of X, row of Y) and
// whether it exists; an entry that does not exist reads slot 0's rows.
struct BmvEntry {
  int zi, ai, bi;
  bool valid;
};

__device__ __forceinline__ BmvEntry bmv_entry(const BmvArgs& a,
                                              const BmvTile& t, int e) {
  BmvEntry en;
  en.bi = e % a.tb;
  const int r = e / a.tb;
  en.ai = r % a.ta;
  en.zi = r / a.ta;
  en.valid = en.zi < t.n_slots && t.a0 + en.ai < a.A && t.b0 + en.bi < a.Bn;
  if (!en.valid) en.zi = en.ai = en.bi = 0;
  return en;
}

template <class T>
__device__ __forceinline__ void bmv_store(const BmvArgs& a, const BmvTile& t,
                                          const BmvEntry& en, T v) {
  static_cast<T*>(a.out)[((long long)(t.z0 + en.zi) * a.A + t.a0 + en.ai) *
                             a.Bn + t.b0 + en.bi] = v;
}

// K <= 32: one thread an entry, one FMA chain over k, read straight from
// device memory.  The entries go in order (entry e = nt blockIdx.x +
// threadIdx.x, so a scenario's sit side by side) and a thread decomposes
// its own in 32-bit arithmetic.  Nothing is staged: no row is read by two
// threads but the vector of a matvec, which L1 serves (staging these rows
// through shared memory took 0.5-1 us more a launch at the call sites'
// shapes, PERF.md).
template <class T>
__device__ __forceinline__ void bmv_seq_body(const BmvArgs& a) {
  const int e = (int)blockIdx.x * a.nt + (int)threadIdx.x;
  if (e >= a.n_seq) return;
  const int b = e % a.Bn, t = e / a.Bn;
  const int r = t % a.A;
  int z = t / a.A;
  long long ox = r * a.sxa, oy = b * a.syb;
  for (int ax = kMaxAxes - 1; ax >= 0 && z > 0; --ax) {
    const int n = a.nz[ax];
    if (n == 1) continue;
    const int q = z / n;
    ox += (z - q * n) * a.sx[ax];
    oy += (z - q * n) * a.sy[ax];
    z = q;
  }
  const T* __restrict__ x = static_cast<const T*>(a.X) + ox;
  const T* __restrict__ y = static_cast<const T*>(a.Y) + oy;
  T acc = 0;
  if (a.K > 0) acc = mul_rn(x[0], y[0]);
  for (int k = 1; k < a.K; ++k)
    acc = fma_rn(x[k * a.sxk], y[k * a.syk], acc);
  static_cast<T*>(a.out)[e] = acc;
}

// Chunk c of k (columns [c kc, c kc + kcl)) of the tile's X and Y rows
// into buffer b: X's rx rows, then Y's; one cp.async group
template <class T>
__device__ __forceinline__ void bmv_stage_chunk(const BmvArgs& a,
                                                const long long* row_off,
                                                int rx, int k0, T* b) {
  const int kcl = min(a.kc, a.K - k0);
  bmv_stage(static_cast<const T*>(a.X), row_off, rx, a.sxk, k0, kcl,
            a.vec_x, a.kp_log2, b, a.rs, a.nt);
  bmv_stage(static_cast<const T*>(a.Y), row_off + rx, a.zt * a.tb, a.syk,
            k0, kcl, a.vec_y, a.kp_log2, b + rx * a.rs, a.rs, a.nt);
  cp_async_commit();
}

// K > 32: G threads an entry; thread j runs lane chains j + G m.  Where K
// takes more than one chunk, two buffers: chunk c + 1 is in flight while
// chunk c is summed.
template <class T, int G>
__device__ __forceinline__ void bmv_lane_body(const BmvArgs& a) {
  constexpr int NL = 32 / G;
  extern __shared__ __align__(16) float smem[];
  __shared__ long long row_off[kMaxRows];
  const BmvTile t = bmv_tile(a, row_off);
  const int rx = a.zt * a.ta;
  const int buf = (rx + a.zt * a.tb) * a.rs;      // one buffer's elements
  T* const b0 = reinterpret_cast<T*>(smem);
  const int j = (int)threadIdx.x % G;
  const BmvEntry en = bmv_entry(a, t, (int)threadIdx.x / G);
  const int ox = (en.zi * a.ta + en.ai) * a.rs + j;
  const int oy = rx * a.rs + (en.zi * a.tb + en.bi) * a.rs + j;
  T acc[NL];
  __syncthreads();       // the table is written
  bmv_stage_chunk(a, row_off, rx, 0, b0);
  for (int k0 = 0, c = 0; k0 < a.K; k0 += a.kc, ++c) {
    const int kcl = min(a.kc, a.K - k0);
    T* const b = b0 + (c % 2) * buf;
    if (k0 + a.kc < a.K) {
      bmv_stage_chunk(a, row_off, rx, k0 + a.kc, b0 + ((c + 1) % 2) * buf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* x = b + ox;
    const T* y = b + oy;
    int kk = 0;
    if (k0 == 0) {       // K > 32: every lane chain has its first product
#pragma unroll
      for (int m = 0; m < NL; ++m) acc[m] = mul_rn(x[G * m], y[G * m]);
      kk = 32;
    }
    for (; kk < kcl; kk += 32) {
#pragma unroll
      for (int m = 0; m < NL; ++m) {
        const int q = kk + G * m;
        if (q + j < kcl) acc[m] = fma_rn(x[q], y[q], acc[m]);
      }
    }
    __syncthreads();     // buffer c % 2 is free for chunk c + 2
  }
  // the butterfly: offsets 16 .. G pair chains inside the thread (lane
  // j + G m with lane j + G (m + h)), G/2 .. 1 pair threads
#pragma unroll
  for (int h = NL / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int m = 0; m < h; ++m) acc[m] = add_rn(acc[m], acc[m + h]);
  }
#pragma unroll
  for (int o = G / 2; o >= 1; o >>= 1)
    acc[0] = add_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], o));
  if (en.valid && j == 0) bmv_store(a, t, en, acc[0]);
}

__global__ void bmv_seq_f32_kernel(BmvArgs a) { bmv_seq_body<float>(a); }
__global__ void bmv_seq_f64_kernel(BmvArgs a) { bmv_seq_body<double>(a); }
__global__ void bmv_lane4_f32_kernel(BmvArgs a) {
  bmv_lane_body<float, 4>(a);
}
__global__ void bmv_lane8_f32_kernel(BmvArgs a) {
  bmv_lane_body<float, 8>(a);
}
__global__ void bmv_lane16_f32_kernel(BmvArgs a) {
  bmv_lane_body<float, 16>(a);
}
__global__ void bmv_lane32_f32_kernel(BmvArgs a) {
  bmv_lane_body<float, 32>(a);
}
__global__ void bmv_lane4_f64_kernel(BmvArgs a) {
  bmv_lane_body<double, 4>(a);
}
__global__ void bmv_lane8_f64_kernel(BmvArgs a) {
  bmv_lane_body<double, 8>(a);
}
__global__ void bmv_lane16_f64_kernel(BmvArgs a) {
  bmv_lane_body<double, 16>(a);
}
__global__ void bmv_lane32_f64_kernel(BmvArgs a) {
  bmv_lane_body<double, 32>(a);
}

inline int pow2_at_least(long long v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// 16-byte pieces of a row can move by cp.async: k stride 1, K, the row
// stride (where there is more than one row), every batch stride and the
// base a multiple of 16 bytes
inline int bmv_vec(const void* p, const long long* sb, long long s_row,
                   long long s_k, int rows, int K, int elt) {
  const long long v = 16 / elt;
  int ok = s_k == 1 && K % v == 0 && (rows == 1 || s_row % v == 0) &&
           (unsigned long long)p % 16 == 0;
  for (int ax = 0; ax < kMaxAxes; ++ax) ok = ok && sb[ax] % v == 0;
  return ok;
}

// The launch shape from (A, Bn, K, dtype) and the strides alone; returns
// G (0 for the K <= 32 path) and the dynamic shared memory in *smem.
inline int bmv_plan(BmvArgs& a, int elt, int* smem) {
  if (a.K <= kSeqMax) {
    a.nt = kBmvSeqThreads;
    a.kc = a.K;
    a.rs = 0;
    a.zt = a.ta = a.tb = a.tiles_b = a.tiles = 0;
    a.vec_x = a.vec_y = a.kp_log2 = 0;
    a.n_seq = (int)((long long)a.Z * a.A * a.Bn);
    *smem = 0;
    return 0;
  }
  int g = pow2_at_least((a.K + kBmvTerms - 1) / kBmvTerms);
  g = g < 4 ? 4 : (g > 32 ? 32 : g);
  const int entries = (a.Bn == 1 ? kBmvMvThreads : kBmvThreads) / g;
  a.tb = a.Bn < entries ? a.Bn : entries;
  a.ta = entries / a.tb;
  a.ta = a.ta < 1 ? 1 : (a.ta > a.A ? a.A : a.ta);
  a.zt = 1;
  if (a.ta == a.A && a.tb == a.Bn) {
    const long long fit = entries / ((long long)a.A * a.Bn);
    a.zt = (int)(fit > kMaxZt ? kMaxZt : (fit < 1 ? 1 : fit));
  }
  // the least a tile stages is two buffers of 32 columns: where they do not
  // fit, fewer scenarios, then fewer rows of the longer side
  while (2LL * a.zt * (a.ta + a.tb) * (32 + g % 32) * elt > kSmemBudget) {
    if (a.zt > 1)
      a.zt = (a.zt + 1) / 2;
    else if (a.ta >= a.tb)
      a.ta = (a.ta + 1) / 2;
    else
      a.tb = (a.tb + 1) / 2;
  }
  a.tiles_b = (a.Bn + a.tb - 1) / a.tb;
  a.tiles = ((a.A + a.ta - 1) / a.ta) * a.tiles_b;
  const long long rows = (long long)a.zt * (a.ta + a.tb);
  // the k chunk: a multiple of 32 (the lane chains run on over chunks),
  // all of K up to kBmvChunk, else kBmvChunk in two buffers (less where
  // they do not fit)
  int nbuf = 1;
  a.kc = (a.K + 31) / 32 * 32;
  if (a.kc > kBmvChunk) {
    nbuf = 2;
    a.kc = kBmvChunk;
  }
  if (a.kc > kSmemBudget / (nbuf * rows * elt) - g % 32) nbuf = 2;
  const long long fit = kSmemBudget / (nbuf * rows * elt) - g % 32;
  if (a.kc > fit) a.kc = fit < 32 ? 32 : (int)(fit / 32 * 32);
  a.rs = a.kc + g % 32;
  a.nt = (int)(((long long)a.zt * a.ta * a.tb * g + 31) / 32 * 32);
  a.vec_x = bmv_vec(a.X, a.sx, a.sxa, a.sxk, a.A, a.K, elt);
  a.vec_y = bmv_vec(a.Y, a.sy, a.syb, a.syk, a.Bn, a.K, elt);
  a.kp_log2 = 0;
  while ((1 << a.kp_log2) < a.kc && a.kp_log2 < 5) ++a.kp_log2;
  *smem = (int)(nbuf * rows * a.rs * elt);
  return g;
}

}  // namespace bggt

// dtype: 0 float32, 1 float64.  nz, sx, sy: kMaxAxes batch axes, outermost
// first (size 1 and stride 0 for an axis not used).  One launch; returns a
// CUDA error code: cudaErrorInvalidValue for a shape the kernel does not
// take.
BGGT_API int bggt_bmv(const void* X, const void* Y, void* out, int dtype,
                      int nz0, int nz1, int nz2, long long sx0,
                      long long sx1, long long sx2, long long sy0,
                      long long sy1, long long sy2, long long sxa,
                      long long sxk, long long syb, long long syk, int A,
                      int Bn, int K, void* stream) {
  if ((dtype != 0 && dtype != 1) || nz0 < 1 || nz1 < 1 || nz2 < 1 ||
      A < 1 || Bn < 1 || K < 0)
    return (int)cudaErrorInvalidValue;
  const long long Z = (long long)nz0 * nz1 * nz2;
  if (Z > 0x7fffffffLL ||
      (K <= bggt::kSeqMax && Z * A * Bn > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  bggt::BmvArgs a{X, Y, out, {sx0, sx1, sx2}, {sy0, sy1, sy2}, sxa, sxk,
                  syb, syk, {nz0, nz1, nz2}, A, Bn, K, (int)Z};
  int smem = 0;
  const int g = bggt::bmv_plan(a, dtype == 0 ? 4 : 8, &smem);
  if (smem > bggt::kSmemBudget || a.nt > 1024 ||
      (g && a.zt * (a.ta + a.tb) > bggt::kMaxRows))
    return (int)cudaErrorInvalidValue;
  const long long blocks = g ? (Z + a.zt - 1) / a.zt * a.tiles
                             : ((long long)a.n_seq + a.nt - 1) / a.nt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void (*k)(bggt::BmvArgs);
  switch (g * 2 + dtype) {
    case 0: k = bggt::bmv_seq_f32_kernel; break;
    case 1: k = bggt::bmv_seq_f64_kernel; break;
    case 8: k = bggt::bmv_lane4_f32_kernel; break;
    case 9: k = bggt::bmv_lane4_f64_kernel; break;
    case 16: k = bggt::bmv_lane8_f32_kernel; break;
    case 17: k = bggt::bmv_lane8_f64_kernel; break;
    case 32: k = bggt::bmv_lane16_f32_kernel; break;
    case 33: k = bggt::bmv_lane16_f64_kernel; break;
    case 64: k = bggt::bmv_lane32_f32_kernel; break;
    default: k = bggt::bmv_lane32_f64_kernel; break;
  }
  k<<<dim3((unsigned)blocks), a.nt, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
