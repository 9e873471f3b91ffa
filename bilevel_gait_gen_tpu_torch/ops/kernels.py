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
  in flight and runs two blocks per SM.  The TPU kernel takes any number
  p of equality rows; the iteration kernel forms and inverts the p x p
  Schur complement in its shared memory only up to p = 32.  For p > 32
  (the centroidal QP: p = 256) the wrapper runs the Schur stage on the
  stream before it, :func:`schur_stage`: A Mi and (A Mi) A^T by
  :func:`rgemm` (``csrc/gtwg.cu``, the kernel of the Newton-Schulz
  product at a rectangular shape), S^-1 by :func:`chol_inverse`
  (``csrc/chol_inverse.cu``, the Cholesky of
  ``pallas_kernels._chol_inverse_unrolled`` blocked on 32-wide panels,
  the upper triangle's tiles in one block's shared memory), and the
  iteration kernel reads A, A Mi and S^-1 from device memory (A Mi in
  place of A and Mi in its KKT solves).  The branch is picked by shape,
  never by a failed launch.
* :func:`gj_inverse` (``csrc/gj_inverse.cu``) replaces
  ``pallas_kernels.gj_inverse``: the batched Gauss-Jordan inverse without
  pivoting, blocked (width 32) for n a multiple of the block width.  One
  block of 256 threads owns one matrix.  Bound by the chain of n / 32
  dependent block steps and by what one SM can feed its FFMA units from its
  own memory, so the matrix stays on the chip: where the caller says how
  many leading rows are real (``n_valid``; the rest is a diagonal padding)
  and they fit a block's shared memory (up to 232 rows), the resident form
  keeps the matrix there from its one load to its one store; else (n = 256)
  the streaming form keeps it in the L2-resident output buffer and stages
  the panels of a step.  :func:`gj_form` picks the form by shape alone.  In
  both, one warp inverts the next diagonal block with shuffles while the
  others run the rank-32 update on 8 x 8 register tiles.
  :func:`spd_inverse` is the tensor code around it (Jacobi scaling, identity
  padding, shift, guarded Newton-Schulz deflation), the exact refresh of
  ``cfg.ipm_inverse="gj"``.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs the
plain PyTorch version only on a CPU tensor; there is no fallback.  Each keeps
a plain integer count of its launches in ``<wrapper>.launches``
(``gj_inverse`` also by form, in ``gj_inverse.launches_by_form``;
``ipm_iter`` by the iteration kernel it launched, in
``ipm_iter.launches_by_kernel``).  The launches go to
``torch.cuda.current_stream()``, so a CUDA graph capture takes them; a
launch made under capture counts once, and the graph's replays do not move
the counts (``utils/graphs.Graphed`` keeps those).  A
launcher sets its kernel's shared-memory limit once, at its first launch,
and makes no other call than the launch after that.

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
_SOURCES = ("common.cuh", "gtwg.cu", "ipm_iter.cu", "gj_inverse.cu",
            "chol_inverse.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "bggt_gtwg": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P],
                  _I),
    "bggt_gemm": ([_P, _P, _P, _I, _I, _F, _F, _I, _P], _I),
    "bggt_rgemm": ([_P, _P, _P, _I, _I, _I, _I, _F, _I, _P], _I),
    "bggt_ipm_iter": ([_P] * 22 + [_I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                                   _I, _P], _I),
    "bggt_ipm_iter_smem_bytes": ([_I, _I, _I, _I], _I),
    "bggt_chol_inverse": ([_P, _P, _I, _I, _P], _I),
    "bggt_chol_inverse_smem_bytes": ([_I], _I),
    "bggt_gj_inverse": ([_P, _P, _I, _I, _I, _I, _P], _I),
    "bggt_gj_smem_bytes": ([_I, _I], _I),
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
    """Compile the CUDA sources (once per source hash, the files side by
    side) and load them.

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


def rgemm_reference(A: torch.Tensor, Bm: torch.Tensor,
                    diag: float = 0.0) -> torch.Tensor:
    """Plain version: A @ Bm (+ diag on the leading diagonal), batched
    [B, R, K] x [B, K, C] -> [B, R, C]."""
    C = A @ Bm
    if diag:
        C = C + diag * torch.eye(C.shape[-2], C.shape[-1], dtype=C.dtype,
                                 device=C.device)
    return C


def rgemm(A: torch.Tensor, Bm: torch.Tensor, *,
          diag: float = 0.0) -> torch.Tensor:
    """Batched A @ Bm + diag I: A [B, R, K], Bm [B, K, Cc] -> [B, R, Cc];
    ``csrc/gtwg.cu::gemm_kernel`` on the card (float32, over k ascending
    with FMA), :func:`rgemm_reference` on CPU tensors."""
    B, R, K = A.shape
    _require(Bm.shape[:2] == (B, K),
             f"Bm {tuple(Bm.shape)} vs A {tuple(A.shape)}")
    if not _on_card(A, Bm):
        return rgemm_reference(A, Bm, diag)
    lib, _ = build()
    A, Bm = A.contiguous(), Bm.contiguous()
    Cc = Bm.shape[-1]
    C = A.new_empty(B, R, Cc)
    _check(lib, lib.bggt_rgemm(_ptr(A), _ptr(Bm), _ptr(C), B, R, Cc, K, diag,
                               int(K % 4 == 0 and _vec16(Cc, A, Bm, C)),
                               _stream()), "rgemm")
    rgemm.launches += 1
    return C


rgemm.launches = 0


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


def chol_inverse(S: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of SPD [B, p, p] by the Cholesky of the unrolled
    version, blocked on 32-wide panels (reads the upper rows; no failure
    check): ``csrc/chol_inverse.cu`` on the card, one block a matrix with
    the upper triangle's 32 x 32 tiles in shared memory, which bounds p
    (320 on a Hopper block); :func:`chol_inverse_unrolled` on CPU
    tensors."""
    B, p, p2 = S.shape
    _require(p == p2, f"square matrices expected, got {tuple(S.shape)}")
    if not _on_card(S):
        return chol_inverse_unrolled(S)
    lib, _ = build()
    need = lib.bggt_chol_inverse_smem_bytes(p)
    _require(need <= MAX_SMEM_BYTES,
             f"p={p}: the triangle's tiles need {need} bytes of shared "
             f"memory")
    S = S.contiguous()
    out = torch.empty_like(S)
    _check(lib, lib.bggt_chol_inverse(_ptr(S), _ptr(out), B, p, _stream()),
           "chol_inverse")
    chol_inverse.launches += 1
    return out


chol_inverse.launches = 0


def schur_stage(A: torch.Tensor, Mi: torch.Tensor,
                reg_s: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(A Mi, S^-1) of the Schur complement S = (A Mi) A^T + reg_s I of a
    sweep (A [B, p, n], Mi [B, n, n]): two :func:`rgemm` products and
    :func:`chol_inverse`, the stage the wrapper of :func:`ipm_iter` runs
    before the iteration kernel where p > :data:`IPM_RESIDENT_P`, which
    takes both.  On CPU tensors the same three functions run their plain
    versions, which are ``_iteration_math``'s with
    ``chol_inverse_unrolled``."""
    AMi = rgemm(A, Mi)
    return AMi, chol_inverse(rgemm(AMi, A.mT.contiguous(), diag=reg_s))


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


IPM_RESIDENT_P = 32   # the iteration kernel forms S itself up to this p


def ipm_iter_launch(lib, stream, H, q, A, b, G, h, g_active, M, Mi, x, y,
                    lam, s, bx, by, blam, bs, bmerit, done_i, it, *, reg,
                    tol, refine_steps, Si=None, AMi=None) -> None:
    """Launch the iteration kernel of csrc/ipm_iter.cu (state in place);
    with ``Si`` and ``AMi`` (the Schur stage's S^-1 and A Mi, p > 32) its
    handed variant."""
    B, m, n = G.shape
    p = A.shape[-2]
    eps = torch.finfo(torch.float32).eps
    w_hi = 0.01 / eps
    rc = lib.bggt_ipm_iter(
        *(_ptr(t) for t in (H, q, A, b, G, h, g_active, M, Mi, Si, AMi, x, y,
                            lam, s, bx, by, blam, bs, bmerit, done_i, it)),
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
    second time, and the result is bit for bit the same.  On the card the
    iterate tensors x, y, lam, s and the ``best`` tuple are updated in
    place (in contiguous copies where they were not contiguous) and
    returned; ``done`` (bool) and ``it`` (int32) come back as new tensors,
    with Mi.  Where p > 32 the Schur stage (:func:`schur_stage`) runs
    before the iteration kernel."""
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
    _require(p > 0, "the sweep needs an equality row")
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
    handed = p > IPM_RESIDENT_P
    if handed:
        need = lib.bggt_ipm_iter_smem_bytes(n, m, p, 1)
        _require(need <= MAX_SMEM_BYTES,
                 f"n={n}, m={m}, p={p}: the vectors need {need} bytes of "
                 f"shared memory")
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
    AMi, Si = (schur_stage(A, Mi, max(reg, 1e-7)) if handed
               else (None, None))
    done_i = done.to(torch.int32)
    ipm_iter_launch(lib, stream, H, q, A, b, G, h, g_active, M, Mi, x, y,
                    lam, s, bx, by, blam, bs, bmerit, done_i, it, reg=reg,
                    tol=tol, refine_steps=refine_steps, Si=Si, AMi=AMi)
    ipm_iter.launches += 1
    ipm_iter.launches_by_kernel[
        "ipm_iter_handed_kernel" if handed else "ipm_iter_kernel"] += 1
    return x, y, lam, s, done_i.bool(), it, (bx, by, blam, bs, bmerit), Mi


ipm_iter.launches = 0
IPM_KERNELS = ("ipm_iter_kernel", "ipm_iter_handed_kernel")
ipm_iter.launches_by_kernel = dict.fromkeys(IPM_KERNELS, 0)


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


def _gj_blocked(M: torch.Tensor, w: int) -> torch.Tensor:
    """Blocked form of ``_gj_kernel_blocked`` with block width ``w``.  Where
    n is not a multiple of ``w`` the last block is the rows that are left,
    widened to ``w`` by a decoupled identity, so that every product sums
    over ``w`` terms as in a matrix padded to a multiple of ``w``."""
    n = M.shape[-1]
    A = M.clone()
    eye = torch.eye(w, dtype=M.dtype, device=M.device)
    for lo in range(0, n, w):
        hi = min(lo + w, n)
        v = hi - lo
        D = eye.expand(*M.shape[:-2], w, w).clone()
        D[..., :v, :v] = A[..., lo:hi, lo:hi]
        Dinv = _gj_scalar(D.clone())
        Dinv = Dinv @ (2.0 * eye - D @ Dinv)
        rowJ = A.new_zeros(*M.shape[:-2], w, n)
        rowJ[..., :v, :] = A[..., lo:hi, :]
        rowJ[..., :, lo:hi] = eye[:, :v]
        rowJ = Dinv @ rowJ
        colz = A.new_zeros(*M.shape[:-2], n, w)
        colz[..., :, :v] = A[..., :, lo:hi]
        colz[..., lo:hi, :] = 0.0
        A = A - colz @ rowJ
        A[..., lo:hi, :] = rowJ[..., :v, :]
        colh = -(colz @ Dinv)
        colh[..., lo:hi, :] = Dinv[..., :v, :]
        A[..., :, lo:hi] = colh[..., :, :v]
    return A


def gj_inverse_reference(M: torch.Tensor, w: int = 128,
                         n_valid: int | None = None) -> torch.Tensor:
    """Plain version of the Gauss-Jordan inverse of [..., n, n] (any device
    and dtype): the blocked form of ``_gj_kernel_blocked`` with block width
    ``w`` when n is a multiple of ``w`` (128 is the JAX kernel's width), the
    scalar form of ``_gj_kernel`` otherwise.

    ``n_valid`` (n a multiple of ``w``) says that the rows and columns from
    ``n_valid`` on are those of a diagonal matrix.  The result is the one of
    the blocked form on all of M, computed from the leading block alone:
    zeros multiply and add exactly, so that block is inverted with a last
    block narrower than ``w``, and a decoupled diagonal entry t comes out of
    the scalar step and the polish as pinv (2 - t pinv), pinv = 1 / t."""
    n = M.shape[-1]
    if n_valid is None or n_valid == n:
        return _gj_blocked(M, w) if n % w == 0 else _gj_scalar(M)
    _require(n % w == 0 and 0 < n_valid < n,
             f"n_valid={n_valid} needs 0 < n_valid <= n={n}, n a multiple "
             f"of {w}")
    t = torch.diagonal(M, dim1=-2, dim2=-1)[..., n_valid:]
    pinv = 1.0 / torch.where(t.abs() < 1e-30, 1e-30, t)
    out = torch.zeros_like(M)
    out[..., :n_valid, :n_valid] = _gj_blocked(
        M[..., :n_valid, :n_valid], w)
    torch.diagonal(out, dim1=-2, dim2=-1)[..., n_valid:] = \
        pinv * (2.0 - t * pinv)
    return out


GJ_FORMS = {"scalar": 0, "resident": 1, "streaming": 2}


def gj_form(lib, n: int, n_valid: int) -> str:
    """Which kernel of csrc/gj_inverse.cu inverts [n, n] matrices whose
    leading ``n_valid`` rows are not diagonal, by shape alone: the scalar
    form when n is no multiple of :data:`GJ_BLOCK`; else the resident form
    (the matrix in the block's shared memory) where its ``n_valid`` rows
    fit, which they do up to 232; else the streaming form."""
    if n % GJ_BLOCK != 0:
        return "scalar"
    if lib.bggt_gj_smem_bytes(GJ_FORMS["resident"],
                              n_valid) <= MAX_SMEM_BYTES:
        return "resident"
    need = lib.bggt_gj_smem_bytes(GJ_FORMS["streaming"], n)
    _require(need <= MAX_SMEM_BYTES,
             f"n={n}: the panels need {need} bytes of shared memory")
    return "streaming"


def gj_launch(lib, stream, M, out, n_valid: int, form: str) -> None:
    """Launch csrc/gj_inverse.cu on contiguous [B, n, n] operands (checked
    by the caller) in the form named."""
    B, n, _ = M.shape
    rc = lib.bggt_gj_inverse(_ptr(M), _ptr(out), B, n, n_valid,
                             GJ_FORMS[form], stream)
    _check(lib, rc, f"gj_inverse ({form})")


def gj_inverse(M: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
    """Batched Gauss-Jordan inverse of SPD [..., n, n] without pivoting.

    ``n_valid``, where given, is the caller's word that the rows and columns
    from ``n_valid`` on are those of a diagonal matrix (an identity padding,
    shifted or not): the result is the same, and the kernel then works on
    the leading block only.  On the card: ``csrc/gj_inverse.cu`` (float32)
    in the form :func:`gj_form` names.  On CPU tensors:
    :func:`gj_inverse_reference`.  There is no Cholesky fallback, unlike the
    JAX wrapper off the TPU."""
    n = M.shape[-1]
    _require(M.ndim >= 2 and M.shape[-2] == n,
             f"square matrices expected, got {tuple(M.shape)}")
    if not _on_card(M):
        return gj_inverse_reference(M, n_valid=n_valid)
    lib, _ = build()
    _require(lib.bggt_gj_block_width() == GJ_BLOCK,
             "kernel block width differs from GJ_BLOCK")
    nv = n if n_valid is None else n_valid
    _require(0 < nv <= n and (nv == n or n % GJ_BLOCK == 0),
             f"n_valid={n_valid} needs 0 < n_valid <= n={n}, n a multiple "
             f"of {GJ_BLOCK}")
    form = gj_form(lib, n, nv)
    Mc = M.contiguous()
    if Mc.data_ptr() % 16:
        Mc = Mc.clone()
    out = torch.empty_like(Mc)
    gj_launch(lib, _stream(), Mc.view(-1, n, n), out, nv, form)
    gj_inverse.launches += 1
    gj_inverse.launches_by_form[form] += 1
    return out


gj_inverse.launches = 0
gj_inverse.launches_by_form = dict.fromkeys(GJ_FORMS, 0)


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
    of 128, invert the shifted matrix M + shift I with :func:`gj_inverse`
    (told that the padding starts at n), deflate the shift with ``deflate``
    guarded Newton-Schulz steps that keep the best-residual iterate per
    matrix, crop and unscale.  The product Mp @ out that a step's candidate
    needs is the one the residual of the iterate kept was taken from, so it
    is carried along: 1 + 2 ``deflate`` batched products a call."""
    n = M.shape[-1]
    Mp, d = spd_scale_pad(M)
    n_p = Mp.shape[-1]
    eye_p = torch.eye(n_p, dtype=M.dtype, device=M.device)
    out = gj_inverse(Mp + shift * eye_p, n_valid=n)
    if deflate:
        def resid(P):
            return torch.amax(torch.abs(P - eye_p), dim=(-2, -1))

        P = Mp @ out
        r_best = resid(P)
        for _ in range(deflate):
            cand = out @ (2.0 * eye_p - P)
            Pc = Mp @ cand
            r = resid(Pc)
            fin = torch.isfinite(r)
            take = ((r < r_best) & fin)[..., None, None]
            out = torch.where(take, cand, out)
            P = torch.where(take, Pc, P)
            r_best = torch.minimum(r_best, torch.where(fin, r, r_best))
    out = out[..., :n, :n]
    return out * d[..., :, None] * d[..., None, :]


def launch_counts() -> dict[str, int]:
    """The launch count of each wrapper, by kernel name."""
    return {"gtwg": gtwg.launches, "ipm_iter": ipm_iter.launches,
            "gj_inverse": gj_inverse.launches, "rgemm": rgemm.launches,
            "chol_inverse": chol_inverse.launches}


def reset_launch_counts() -> None:
    gtwg.launches = 0
    ipm_iter.launches = 0
    ipm_iter.launches_by_kernel = dict.fromkeys(IPM_KERNELS, 0)
    rgemm.launches = 0
    chol_inverse.launches = 0
    gj_inverse.launches = 0
    gj_inverse.launches_by_form = dict.fromkeys(GJ_FORMS, 0)
