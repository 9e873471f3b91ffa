"""Hand-written Hopper kernels of the main path, with their plain versions.

Ports of the three TPU kernels of
``bilevel_gait_gen_tpu/ops/pallas_kernels.py``:

* :func:`gtwg` (``csrc/gtwg.cu``) replaces ``pallas_kernels.gtwg``:
  batched M = H + G^T diag(W) G (+ reg I).  Bound on this card by FP32 FFMA
  throughput (the triangle of the symmetric product is m n (n + 1) flop per
  problem; no tensor-core path keeps float32 inputs).  The design: 128x128
  output tiles on and above the diagonal only, each also written to its
  mirrored place (G^T W G comes out exactly symmetric), an 8x8 register tile
  per thread fed by 16-byte shared-memory loads, slabs of G staged by
  ``cp.async`` in a four-stage ring and scaled by W in shared memory.
* :func:`ipm_iter` (``csrc/ipm_iter.cu`` plus the two kernels of
  ``csrc/gtwg.cu``) replaces ``pallas_kernels.ipm_iter``: one fused
  Mehrotra sweep.  A problem does not fit in one block's shared memory
  (M alone is 256 KB at n = 256), so the wrapper chains gtwg (M, with
  W = clip(lam / s) formed in the kernel; skipped when the caller hands
  over the M it formed for an exact refresh), the batched GEMM of the
  Newton-Schulz refresh when ``do_ns`` (the tile design of gtwg, without
  the symmetry), and one block per problem for the rest of the iteration.
  M and the Newton-Schulz products are bound by FP32 FFMA throughput; the
  iteration kernel by device-memory traffic (G is streamed five times per
  sweep, Mi nine times, M twice, and at 512 problems none of them stays in
  the 50 MB L2): it keeps every vector in shared memory, shares one pass
  over G between the two residual products, keeps two rows of every warp
  in flight and runs two blocks per SM.
* :func:`gj_inverse` (``csrc/gj_inverse.cu``) replaces
  ``pallas_kernels.gj_inverse``: the batched Gauss-Jordan inverse without
  pivoting, blocked for n a multiple of the block width.  One block owns
  one matrix, which stays in the output buffer (L2 resident at the main
  path's batch); the diagonal block and the panels of a step are staged in
  shared memory.  Latency bound on the chain of n dependent pivot steps.
  :func:`spd_inverse` is the tensor code around it (Jacobi scaling, identity
  padding, shift, guarded Newton-Schulz deflation), the exact refresh of
  ``cfg.ipm_inverse="gj"``.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs the
plain PyTorch version only on a CPU tensor; there is no fallback.  Each keeps
a plain integer count of its launches in ``<wrapper>.launches``.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` at first use
(one compiler per source file, side by side) into
``bilevel_gait_gen_tpu_torch/_build/<hash of the sources>/`` and loaded with
``ctypes``; nothing is built or imported from CUDA when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
_SOURCES = ("common.cuh", "gtwg.cu", "ipm_iter.cu", "gj_inverse.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "bggt_gtwg": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P],
                  _I),
    "bggt_gemm": ([_P, _P, _P, _I, _I, _F, _F, _I, _P], _I),
    "bggt_ipm_iter": ([_P] * 20 + [_I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                                   _I, _P], _I),
    "bggt_gj_inverse": ([_P, _P, _I, _I, _I, _P], _I),
    "bggt_gj_smem_bytes": ([_I], _I),
    "bggt_gj_block_width": ([], _I),
    "bggt_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked in PATH and {home}/bin)")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def bind(path: str | os.PathLike) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def _compile(out_dir: Path, lib_path: Path) -> None:
    """One nvcc per source, all started together, then the link.  The
    commands and the compilers' output go to ``build.log``."""
    nvcc, tag = _nvcc(), os.getpid()
    units = [n for n in _SOURCES if n.endswith(".cu")]
    objs = [out_dir / f"{Path(n).stem}.{tag}.o" for n in units]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / n), "-o", str(o)]
            for n, o in zip(units, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log = [" ".join(c) + "\n" + pr.communicate()[0]
           for c, pr in zip(cmds, procs)]
    failed = any(pr.returncode != 0 for pr in procs)
    if not failed:
        tmp = out_dir / f"libbggt_kernels.{tag}.tmp.so"
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        failed = res.returncode != 0
    for o in objs:
        o.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(tmp, lib_path)


def build() -> tuple[ctypes.CDLL, Path]:
    """Compile the CUDA sources (once per source hash, the three files side
    by side) and load them.

    The library goes to ``_build/<hash>/``; the compiler's ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside it as
    ``build.log``.  A failed build raises with the compiler's output.
    Once loaded, a call costs nothing: the sources are hashed only before
    the first load, not at every launch."""
    global _lib, _lib_path
    if _lib is None:
        out_dir = BUILD_ROOT / source_hash()
        lib_path = out_dir / "libbggt_kernels.so"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            _compile(out_dir, lib_path)
        _lib, _lib_path = bind(lib_path), lib_path
    return _lib, _lib_path


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.bggt_error_string(rc).decode()})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _on_card(*ts: torch.Tensor) -> bool:
    """True for CUDA float32 (or int32 state) operands, False for CPU
    tensors; anything else raises.  The wrappers make operands contiguous
    themselves."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    _require(dev.type == "cuda", f"unsupported device {dev}")
    for t in ts:
        _require(t.device == dev, "operands on different devices")
        _require(t.dtype in (torch.float32, torch.int32),
                 f"kernels take float32 (and int32 state), got {t.dtype}")
    return True


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _vec16(n: int, *ts: torch.Tensor) -> int:
    """1 if rows of n floats of these operands can move as 16-byte pieces
    (n a multiple of 4, every base 16-byte aligned), else 0: the kernels
    then take their scalar copies."""
    return int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


# ----------------------------------------------------------------------------
# gtwg
# ----------------------------------------------------------------------------

def gtwg_reference(H, G, W, reg: float = 0.0) -> torch.Tensor:
    """Plain version: H + G^T diag(W) G + reg I, batched [B, n, n]."""
    M = H + torch.einsum('bmi,bmj->bij', G * W[..., None], G)
    if reg:
        M = M + reg * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return M


def gtwg_launch(lib, stream, H, G, W, lam, s, out, reg, w_lo, w_hi) -> None:
    """Launch csrc/gtwg.cu on raw operands (checked by the caller)."""
    B, m, n = G.shape
    rc = lib.bggt_gtwg(_ptr(H), _ptr(G), _ptr(W), _ptr(lam), _ptr(s),
                       _ptr(out), B, m, n, reg, w_lo, w_hi,
                       _vec16(n, H, G, out), stream)
    _check(lib, rc, "gtwg")


def ns_gemm_launch(lib, stream, A, Bm, C, alpha: float, diag: float) -> None:
    """Launch the batched square product of csrc/gtwg.cu on contiguous
    [B, n, n] operands: C = alpha A Bm + diag I."""
    B, n, _ = A.shape
    rc = lib.bggt_gemm(_ptr(A), _ptr(Bm), _ptr(C), B, n, alpha, diag,
                       _vec16(n, A, Bm, C), stream)
    _check(lib, rc, "ns gemm")


def gtwg(H: torch.Tensor, G: torch.Tensor, W: torch.Tensor | None = None, *,
         lam: torch.Tensor | None = None, s: torch.Tensor | None = None,
         w_hi: float | None = None, reg: float = 0.0) -> torch.Tensor:
    """Batched M = H + G^T diag(W) G + reg I: H [B, n, n], G [B, m, n],
    W [B, m] -> [B, n, n].  Instead of W the caller may pass lam and s
    [B, m]: then W = clip(lam / s, 1 / w_hi, w_hi), formed in the kernel
    (the interior-point scaling)."""
    from_ls = W is None
    if from_ls:
        _require(lam is not None and s is not None and w_hi is not None,
                 "gtwg needs W, or lam, s and w_hi")
    B, m, n = G.shape
    _require(H.shape == (B, n, n), f"H {tuple(H.shape)} vs G {tuple(G.shape)}")
    vecs = (lam, s) if from_ls else (W,)
    for v in vecs:
        _require(v.shape == (B, m), f"weights {tuple(v.shape)} vs m={m}")
    if not _on_card(H, G, *vecs):
        if from_ls:
            W = torch.clamp(lam / s, 1.0 / w_hi, w_hi)
        return gtwg_reference(H, G, W, reg)
    lib, _ = build()
    H, G = H.contiguous(), G.contiguous()
    W, lam, s = (None if v is None else v.contiguous() for v in (W, lam, s))
    out = torch.empty_like(H)
    w_lo_f, w_hi_f = (1.0 / w_hi, w_hi) if from_ls else (0.0, 0.0)
    gtwg_launch(lib, _stream(), H, G, W, lam, s, out, reg, w_lo_f, w_hi_f)
    gtwg.launches += 1
    return out


gtwg.launches = 0


# ----------------------------------------------------------------------------
# ipm_iter
# ----------------------------------------------------------------------------

def chol_inverse_unrolled(S: torch.Tensor) -> torch.Tensor:
    """Explicit SPD inverse of a small [..., p, p] matrix by the unrolled
    Cholesky of ``pallas_kernels._chol_inverse_unrolled`` (reads the upper
    rows, no symmetrization, no failure check: a bad pivot gives inf/NaN)."""
    p = S.shape[-1]
    idx = torch.arange(p, device=S.device)
    U = torch.zeros_like(S)
    Wk = S.clone()
    for k in range(p):
        piv = torch.clamp_min(Wk[..., k, k], 1e-30)
        u_k = Wk[..., k, :] * torch.rsqrt(piv)[..., None]
        u_k = torch.where(idx >= k, u_k, 0.0)
        U[..., k, :] = u_k
        Wk = Wk - u_k[..., None, :] * u_k[..., :, None]
    X = torch.zeros_like(S)
    for k in range(p - 1, -1, -1):
        e_k = (idx == k).to(S.dtype)
        acc = (U[..., k:k + 1, :] @ X)[..., 0, :]
        X[..., k, :] = (e_k - acc) / U[..., k, k:k + 1]
    return X @ X.mT


def ipm_iter_reference(H, q, A, b, G, h, g_active, x, y, lam, s, done, it,
                       best, Mi_in, do_ns: bool, *, reg: float, tol: float,
                       refine_steps: int, ns_steps: int, M=None):
    """Plain version of one fused sweep (any device): M with the sweep's
    W (or the ``M`` handed in, which must be that matrix), the
    Newton-Schulz refresh of Mi_in when ``do_ns`` (without the non-finite
    fallback, as in the TPU kernel), then ``pdip._iteration_math`` with the
    unrolled Schur inverse.  Returns (x, y, lam, s, done, it, best, Mi) as
    new tensors."""
    from bilevel_gait_gen_tpu_torch.ops import pdip

    if M is None:
        w_hi = 0.01 / torch.finfo(q.dtype).eps
        M = gtwg_reference(H, G, torch.clamp(lam / s, 1.0 / w_hi, w_hi), reg)
    Mi = Mi_in
    if do_ns:
        I2 = 2.0 * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        for _ in range(ns_steps):
            Mi = Mi @ (I2 - M @ Mi)
    x, y, lam, s, done, it, best = pdip._iteration_math(
        H, q, A, b, G, h, g_active, x, y, lam, s, done, it, best, M, Mi,
        reg=reg, tol=tol, refine_steps=refine_steps,
        chol_inverse_fn=chol_inverse_unrolled)
    return x, y, lam, s, done, it, best, Mi


def ipm_iter_launch(lib, stream, H, q, A, b, G, h, g_active, M, Mi, x, y,
                    lam, s, bx, by, blam, bs, bmerit, done_i, it, *, reg,
                    tol, refine_steps) -> None:
    """Launch the iteration kernel of csrc/ipm_iter.cu (state in place)."""
    B, m, n = G.shape
    p = A.shape[-2]
    eps = torch.finfo(torch.float32).eps
    w_hi = 0.01 / eps
    rc = lib.bggt_ipm_iter(
        *(_ptr(t) for t in (H, q, A, b, G, h, g_active, M, Mi, x, y, lam, s,
                            bx, by, blam, bs, bmerit, done_i, it)),
        B, n, m, p, max(reg, 1e-7), tol, 1e3 * tol, 1.0 / w_hi, w_hi, eps,
        refine_steps, stream)
    _check(lib, rc, "ipm_iter")


def ipm_iter(H, q, A, b, G, h, g_active, x, y, lam, s, done, it, best,
             Mi_in, do_ns: bool, *, reg: float, tol: float,
             refine_steps: int, ns_steps: int, M=None):
    """One fused interior-point sweep (math: ``pdip._iteration_math``).

    Operands are batched [B, ...] and padded so that n and m are multiples
    of 128 (``pdip._solve_impl`` does this).  ``do_ns`` (a host bool: it
    depends only on the sweep index) refreshes Mi_in by Newton-Schulz
    before the iteration.  ``M``, when given, is the sweep's matrix
    ``gtwg(H, G, lam=lam, s=s, w_hi=0.01 / eps, reg=reg)`` that the caller
    has formed already (for an exact refresh): it is then not formed a
    second time, and the result is bit for bit the same.  On the card the iterate tensors x, y, lam, s and
    the ``best`` tuple are updated in place (in contiguous copies where
    they were not contiguous) and returned; ``done`` (bool) and ``it``
    (int32) come back as new tensors, with Mi."""
    bx, by, blam, bs, bmerit = best
    B, m, n = G.shape
    p = A.shape[-2]
    if not _on_card(H, q, A, b, G, h, g_active, x, y, lam, s, bx, by, blam,
                    bs, bmerit, Mi_in, it, *(() if M is None else (M,))):
        return ipm_iter_reference(
            H, q, A, b, G, h, g_active, x, y, lam, s, done, it, best, Mi_in,
            do_ns, reg=reg, tol=tol, refine_steps=refine_steps,
            ns_steps=ns_steps, M=M)
    _require(n % 128 == 0 and m % 128 == 0, "pad n and m to multiples of 128")
    _require(n <= 2048, f"n={n}: a row of n floats is split over 16 warps")
    _require(0 < p <= 32, f"p={p}: the Schur block holds at most 32 rows")
    for name, t, shape in (("H", H, (B, n, n)), ("Mi", Mi_in, (B, n, n)),
                           ("A", A, (B, p, n)), ("q", q, (B, n)),
                           ("x", x, (B, n)), ("bx", bx, (B, n)),
                           ("b", b, (B, p)), ("y", y, (B, p)),
                           ("by", by, (B, p)), ("h", h, (B, m)),
                           ("g_active", g_active, (B, m)),
                           ("lam", lam, (B, m)), ("s", s, (B, m)),
                           ("blam", blam, (B, m)), ("bs", bs, (B, m)),
                           ("bmerit", bmerit, (B,)), ("it", it, (B,)),
                           ("done", done, (B,))):
        _require(tuple(t.shape) == shape, f"{name} {tuple(t.shape)} != {shape}")
    _require(it.dtype == torch.int32 and done.dtype == torch.bool,
             "it must be int32 and done bool")
    lib, _ = build()
    stream = _stream()
    H, q, A, b, G, h, g_active, Mi_in, x, y, lam, s, bx, by, blam, bs, \
        bmerit, it = (t.contiguous() for t in (
            H, q, A, b, G, h, g_active, Mi_in, x, y, lam, s, bx, by, blam,
            bs, bmerit, it))
    if M is None:
        eps = torch.finfo(torch.float32).eps
        M = gtwg(H, G, lam=lam, s=s, w_hi=0.01 / eps, reg=reg)
    else:
        _require(tuple(M.shape) == (B, n, n),
                 f"M {tuple(M.shape)} != {(B, n, n)}")
        M = M.contiguous()
    Mi = Mi_in
    if do_ns:
        T = torch.empty_like(Mi)
        for _ in range(ns_steps):
            X = torch.empty_like(Mi)
            ns_gemm_launch(lib, stream, M, Mi, T, -1.0, 2.0)
            ns_gemm_launch(lib, stream, Mi, T, X, 1.0, 0.0)
            Mi = X
    done_i = done.to(torch.int32)
    ipm_iter_launch(lib, stream, H, q, A, b, G, h, g_active, M, Mi, x, y,
                    lam, s, bx, by, blam, bs, bmerit, done_i, it, reg=reg,
                    tol=tol, refine_steps=refine_steps)
    ipm_iter.launches += 1
    return x, y, lam, s, done_i.bool(), it, (bx, by, blam, bs, bmerit), Mi


ipm_iter.launches = 0


# ----------------------------------------------------------------------------
# gj_inverse / spd_inverse
# ----------------------------------------------------------------------------

GJ_BLOCK = 32             # block width of csrc/gj_inverse.cu (kW)
MAX_SMEM_BYTES = 232448   # dynamic shared memory one Hopper block may use


def _gj_scalar(A: torch.Tensor) -> torch.Tensor:
    """Masked scalar Gauss-Jordan inverse of [..., n, n] without pivoting
    (``pallas_kernels._gj_kernel`` / ``_gj_block``): n rank-1 steps; a pivot
    with |p| < 1e-30 becomes 1e-30 and the elimination goes on."""
    n = A.shape[-1]
    for j in range(n):
        p = A[..., j, j]
        pinv = 1.0 / torch.where(p.abs() < 1e-30, 1e-30, p)
        rowj = A[..., j, :] * pinv[..., None]
        rowj[..., j] = pinv
        colz = A[..., :, j].clone()
        colz[..., j] = 0.0
        upd = A - colz[..., :, None] * rowj[..., None, :]
        upd[..., j, :] = rowj
        colh = -(pinv[..., None] * colz)
        colh[..., j] = pinv
        upd[..., :, j] = colh
        A = upd
    return A


def gj_inverse_reference(M: torch.Tensor, w: int = 128) -> torch.Tensor:
    """Plain version of the Gauss-Jordan inverse of [..., n, n] (any device
    and dtype): the blocked form of ``_gj_kernel_blocked`` with block width
    ``w`` when n is a multiple of ``w`` (128 is the JAX kernel's width), the
    scalar form of ``_gj_kernel`` otherwise."""
    n = M.shape[-1]
    if n % w != 0:
        return _gj_scalar(M)
    A = M.clone()
    eye2 = 2.0 * torch.eye(w, dtype=M.dtype, device=M.device)
    for lo in range(0, n, w):
        hi = lo + w
        D = A[..., lo:hi, lo:hi].clone()
        Dinv = _gj_scalar(D)
        Dinv = Dinv @ (eye2 - D @ Dinv)
        rowJ = A[..., lo:hi, :].clone()
        rowJ[..., :, lo:hi] = 0.5 * eye2
        rowJ = Dinv @ rowJ
        colz = A[..., :, lo:hi].clone()
        colz[..., lo:hi, :] = 0.0
        A = A - colz @ rowJ
        A[..., lo:hi, :] = rowJ
        colh = -(colz @ Dinv)
        colh[..., lo:hi, :] = Dinv
        A[..., :, lo:hi] = colh
    return A


def gj_inverse(M: torch.Tensor) -> torch.Tensor:
    """Batched Gauss-Jordan inverse of SPD [..., n, n] without pivoting.

    On the card: ``csrc/gj_inverse.cu`` (float32), the blocked form with
    block width :data:`GJ_BLOCK` when n is a multiple of it, else the scalar
    form.  On CPU tensors: :func:`gj_inverse_reference`.  There is no
    Cholesky fallback, unlike the JAX wrapper off the TPU."""
    n = M.shape[-1]
    _require(M.ndim >= 2 and M.shape[-2] == n,
             f"square matrices expected, got {tuple(M.shape)}")
    if not _on_card(M):
        return gj_inverse_reference(M)
    lib, _ = build()
    _require(lib.bggt_gj_block_width() == GJ_BLOCK,
             "kernel block width differs from GJ_BLOCK")
    blocked = n % GJ_BLOCK == 0
    if blocked:
        need = lib.bggt_gj_smem_bytes(n)
        _require(need <= MAX_SMEM_BYTES,
                 f"n={n}: the panels need {need} bytes of shared memory")
    Mc = M.contiguous()
    out = torch.empty_like(Mc)
    B = Mc.numel() // (n * n)
    _check(lib, lib.bggt_gj_inverse(_ptr(Mc), _ptr(out), B, n, int(blocked),
                                    _stream()), "gj_inverse")
    gj_inverse.launches += 1
    return out


gj_inverse.launches = 0


def spd_scale_pad(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The matrix :func:`spd_inverse` works on: M Jacobi-scaled to unit
    diagonal and padded with an identity block to a multiple of 128.
    Returns (Mp [..., n_p, n_p], d [..., n]) with Mp[:n, :n] = D M D."""
    n = M.shape[-1]
    n_p = -(-n // 128) * 128
    dg = torch.diagonal(M, dim1=-2, dim2=-1)
    d = torch.rsqrt(torch.maximum(
        dg, 1e-12 * torch.clamp_min(torch.amax(dg, dim=-1, keepdim=True),
                                    1.0)))
    Mp = M * d[..., :, None] * d[..., None, :]
    if n_p != n:
        Mp = torch.nn.functional.pad(Mp, (0, n_p - n, 0, n_p - n))
        tail = torch.cat([M.new_zeros(n), M.new_ones(n_p - n)])
        Mp = Mp + torch.diag(tail)
    return Mp, d


def spd_inverse(M: torch.Tensor, *, shift: float = 1e-3,
                deflate: int = 10) -> torch.Tensor:
    """SPD inverse of [..., n, n] for any n (``pallas_kernels.spd_inverse``):
    Jacobi-scale to unit diagonal, pad with an identity block to a multiple
    of 128, invert the shifted matrix M + shift I with :func:`gj_inverse`,
    deflate the shift with ``deflate`` guarded Newton-Schulz steps that keep
    the best-residual iterate per matrix, crop and unscale."""
    n = M.shape[-1]
    Mp, d = spd_scale_pad(M)
    n_p = Mp.shape[-1]
    eye_p = torch.eye(n_p, dtype=M.dtype, device=M.device)
    out = gj_inverse(Mp + shift * eye_p)
    if deflate:
        def resid(X):
            return torch.amax(torch.abs(Mp @ X - eye_p), dim=(-2, -1))

        r_best = resid(out)
        for _ in range(deflate):
            cand = out @ (2.0 * eye_p - Mp @ out)
            r = resid(cand)
            fin = torch.isfinite(r)
            take = (r < r_best) & fin
            out = torch.where(take[..., None, None], cand, out)
            r_best = torch.minimum(r_best, torch.where(fin, r, r_best))
    out = out[..., :n, :n]
    return out * d[..., :, None] * d[..., None, :]


def reset_launch_counts() -> None:
    gtwg.launches = 0
    ipm_iter.launches = 0
    gj_inverse.launches = 0
