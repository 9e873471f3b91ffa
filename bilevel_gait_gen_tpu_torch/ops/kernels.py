"""Hand-written Hopper kernels of the main path, with their plain versions.

Ports of the two TPU kernels of ``bilevel_gait_gen_tpu/ops/pallas_kernels.py``
that the bench cadence reaches:

* :func:`gtwg` (``csrc/gtwg.cu``) replaces ``pallas_kernels.gtwg``:
  batched M = H + G^T diag(W) G (+ reg I).  Bound on this card by FP32 FFMA
  throughput (2 n^2 m flop per problem, no float32-input tensor-core path);
  the simple design is a 64x64 register-tiled block per output tile that
  loops over the rows of G, scaling them by W as they are loaded.
* :func:`ipm_iter` (``csrc/ipm_iter.cu`` plus the two kernels of
  ``csrc/gtwg.cu``) replaces ``pallas_kernels.ipm_iter``: one fused
  Mehrotra sweep.  A problem does not fit in one block's shared memory
  (M alone is 256 KB at n = 256), so the wrapper chains gtwg (M, with
  W = clip(lam / s) formed in the kernel), the batched GEMM of the
  Newton-Schulz refresh when ``do_ns``, and one block per problem for the
  rest of the iteration.  Bound by memory traffic (G, M and Mi are streamed
  several times per sweep, mostly from L2); the simple design keeps every
  vector in shared memory and reads matrices with whole warps.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs the
plain PyTorch version only on a CPU tensor; there is no fallback.  Each keeps
a plain integer count of its launches in ``<wrapper>.launches``.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` at first use into
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
_SOURCES = ("common.cuh", "gtwg.cu", "ipm_iter.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "bggt_gtwg": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P], _I),
    "bggt_gemm": ([_P, _P, _P, _I, _I, _F, _F, _P], _I),
    "bggt_ipm_iter": ([_P] * 20 + [_I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                                   _I, _P], _I),
    "bggt_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None


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


def build() -> tuple[ctypes.CDLL, Path]:
    """Compile the CUDA sources (once per source hash) and load them.

    The library goes to ``_build/<hash>/``; the compiler's ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside it as
    ``build.log``.  A failed build raises with the compiler's output."""
    global _lib
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libbggt_kernels.so"
    if _lib is None:
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libbggt_kernels.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(CSRC / n) for n in _SOURCES if n.endswith(".cu"))]
            res = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / "build.log").write_text(
                " ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
            os.replace(tmp, lib_path)
        _lib = bind(lib_path)
    return _lib, lib_path


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
                       _ptr(out), B, m, n, reg, w_lo, w_hi, stream)
    _check(lib, rc, "gtwg")


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
                       refine_steps: int, ns_steps: int):
    """Plain version of one fused sweep (any device): M with the sweep's
    W, the Newton-Schulz refresh of Mi_in when ``do_ns`` (without the
    non-finite fallback, as in the TPU kernel), then
    ``pdip._iteration_math`` with the unrolled Schur inverse.  Returns
    (x, y, lam, s, done, it, best, Mi) as new tensors."""
    from bilevel_gait_gen_tpu_torch.ops import pdip

    eps = torch.finfo(q.dtype).eps
    w_hi = 0.01 / eps
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
             refine_steps: int, ns_steps: int):
    """One fused interior-point sweep (math: ``pdip._iteration_math``).

    Operands are batched [B, ...] and padded so that n and m are multiples
    of 128 (``pdip._solve_impl`` does this).  ``do_ns`` (a host bool: it
    depends only on the sweep index) refreshes Mi_in by Newton-Schulz
    before the iteration.  On the card the iterate tensors x, y, lam, s and
    the ``best`` tuple are updated in place (in contiguous copies where
    they were not contiguous) and returned; ``done`` (bool) and ``it``
    (int32) come back as new tensors, with Mi."""
    bx, by, blam, bs, bmerit = best
    B, m, n = G.shape
    p = A.shape[-2]
    if not _on_card(H, q, A, b, G, h, g_active, x, y, lam, s, bx, by, blam,
                    bs, bmerit, Mi_in, it):
        return ipm_iter_reference(
            H, q, A, b, G, h, g_active, x, y, lam, s, done, it, best, Mi_in,
            do_ns, reg=reg, tol=tol, refine_steps=refine_steps,
            ns_steps=ns_steps)
    _require(n % 128 == 0 and m % 128 == 0, "pad n and m to multiples of 128")
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
    eps = torch.finfo(torch.float32).eps
    M = gtwg(H, G, lam=lam, s=s, w_hi=0.01 / eps, reg=reg)
    Mi = Mi_in
    if do_ns:
        T = torch.empty_like(Mi)
        for _ in range(ns_steps):
            X = torch.empty_like(Mi)
            _check(lib, lib.bggt_gemm(_ptr(M), _ptr(Mi), _ptr(T), B, n, -1.0,
                                      2.0, stream), "ns gemm")
            _check(lib, lib.bggt_gemm(_ptr(Mi), _ptr(T), _ptr(X), B, n, 1.0,
                                      0.0, stream), "ns gemm")
            Mi = X
    done_i = done.to(torch.int32)
    ipm_iter_launch(lib, stream, H, q, A, b, G, h, g_active, M, Mi, x, y,
                    lam, s, bx, by, blam, bs, bmerit, done_i, it, reg=reg,
                    tol=tol, refine_steps=refine_steps)
    ipm_iter.launches += 1
    return x, y, lam, s, done_i.bool(), it, (bx, by, blam, bs, bmerit), Mi


ipm_iter.launches = 0


def reset_launch_counts() -> None:
    gtwg.launches = 0
    ipm_iter.launches = 0
