"""Checks, timings and bounds of the hand-written kernels on the card,
shared by ``chip_smoke.py`` and ``bench_torch.py``.

Each kernel is held to its plain PyTorch version (``kernels.*_reference``)
on the same inputs with the tolerances below, timed between CUDA events,
and set beside its bound on an H100: the larger of its operations over the
float32 peak and its bytes over the memory rate.
"""
from __future__ import annotations

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch.ops import kernels

TOL_GTWG = 1e-5     # max|dM| / max|M|: float32 sums of 1232 products
TOL_ITER = 1e-3     # iterate max|d| / max|ref| after one float32 sweep
                    # (or 2x the plain version's float32-vs-float64 gap)
TOL_ITER_CAP = 0.05
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, and device-memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10, warm: int = 2, inner: int = 1) -> float:
    """Median over ``reps`` timings of one call, each between two CUDA
    events (of ``inner`` calls in a row, divided by ``inner``: for a bare
    launch, whose host side would otherwise show in the window)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes (each input read once, each output written once)
    over the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gtwg_work(B: int, m: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of M = H + G^T W G + reg I at [B, m, n]: the
    triangle of the symmetric product, B m n (n + 1); H, G, lam and s read
    once, M written once."""
    return 1.0 * B * m * n * (n + 1), 4.0 * B * (2 * n * n + m * n + 2 * m)


def sweep_work(B: int, m: int, n: int, p: int,
               ns_steps: int) -> tuple[float, float, float]:
    """(operations of a sweep with its Newton-Schulz refresh, operations of
    the iteration alone, bytes) at [B, n, m, p]: the triangle of M, 2
    products per Newton-Schulz step, then the iteration's matrix-vector work
    (two directions with one refinement each: ~22 n^2 + 12 m n + 2 p n^2
    per problem).  A sweep reads H, G, A, Mi and the vectors once and writes
    Mi and the vectors; the exact sweep handed its M has the iteration's
    operations only and reads M too."""
    iter_flops = B * (22.0 * n * n + 12.0 * m * n + 2.0 * p * n * n)
    ns_flops = 2.0 * B * n ** 3
    nbytes = 4.0 * B * (3 * n * n + m * n + p * n + 4 * (n + p + 2 * m)
                        + 3 * m)
    return (gtwg_work(B, m, n)[0] + ns_steps * 2 * ns_flops + iter_flops,
            iter_flops, nbytes)


def rel_err(got, ref) -> float:
    scale = float(torch.amax(torch.abs(ref)))
    return float(torch.amax(torch.abs(got - ref))) / max(scale, 1e-30)


def clone_args(args):
    return [a.clone() if hasattr(a, "clone") else
            tuple(b.clone() for b in a) if isinstance(a, tuple) else a
            for a in args]


def fresh_state(args):
    """A captured ipm_iter call with clones of what the sweep writes (x, y,
    lam, s, it and the best iterate) and the read-only operands as they
    are."""
    out = list(args)
    for i in (7, 8, 9, 10, 12):
        out[i] = args[i].clone()
    out[13] = tuple(b.clone() for b in args[13])
    return out


def to_float64(args):
    """Float64 copies of a captured ipm_iter call (for the plain version)."""
    return [tuple(b.double() if b.is_floating_point() else b.clone()
                  for b in a) if isinstance(a, tuple)
            else (a.double() if a.is_floating_point() else a.clone())
            if hasattr(a, "clone") else a for a in args]


def check_gtwg(H, G, lam, s, w_hi, reg, label):
    """gtwg against its plain version; returns (rel, abs) errors."""
    M = kernels.gtwg(H, G, lam=lam, s=s, w_hi=w_hi, reg=reg)
    W = torch.clamp(lam / s, 1.0 / w_hi, w_hi)
    ref = kernels.gtwg_reference(H, G, W, reg)
    torch.cuda.synchronize()
    err = rel_err(M, ref)
    check(err <= TOL_GTWG, f"gtwg {label} max|dM|/max|M| {err:.3e}")
    return err, float(torch.amax(torch.abs(M - ref)))


def time_gemms(H, G, lam, s, w_hi, reg):
    """gtwg through its wrapper, the PyTorch call for the same function
    (baddbmm on the scaled G), the Newton-Schulz product as a bare launch
    and its PyTorch call, at the batch of the operands: milliseconds."""
    lib, _ = kernels.build()
    Wl = torch.clamp(lam / s, 1.0 / w_hi, w_hi)
    X, Y = H, torch.empty_like(H)
    eye = torch.eye(H.shape[-1], device=H.device).expand_as(H)
    return dict(
        gtwg=cuda_ms(lambda: kernels.gtwg(H, G, lam=lam, s=s, w_hi=w_hi,
                                          reg=reg)),
        gtwg_library=cuda_ms(
            lambda: torch.baddbmm(H, (G * Wl[..., None]).mT, G)),
        ns_gemm=cuda_ms(lambda: kernels.ns_gemm_launch(
            lib, kernels._stream(), X, X, Y, -1.0, 2.0), inner=4),
        ns_gemm_library=cuda_ms(
            lambda: torch.baddbmm(eye, X, X, beta=2.0, alpha=-1.0)))


def compare_ipm_iter(args, kw, label: str) -> dict:
    """One recorded ``kernels.ipm_iter`` call against its plain version on
    the same inputs.  x, y, lam and s are each held to 1e-3 of max|ref|, or
    to twice the plain version's own distance to the same sweep computed in
    float64 (M too) where float32 is less accurate than that (cold-start
    sweeps are), never more than TOL_ITER_CAP; done and it must be equal.

    Returns per iterate (name, error, float32-vs-float64 error, tolerance),
    the worst error against its tolerance, the largest absolute difference,
    ``moved``: how far the plain version moved x, lam and s from the inputs,
    as the largest of their relative changes over their tolerances (above 1
    where the comparison could see a kernel that wrote nothing), and
    ``stepped``: the problems whose x the kernel changed."""
    kw64 = {k: v for k, v in kw.items() if k != "M"}
    got = kernels.ipm_iter(*clone_args(args), **kw)
    ref = kernels.ipm_iter_reference(*clone_args(args), **kw)
    r64 = kernels.ipm_iter_reference(*to_float64(args), **kw64)
    torch.cuda.synchronize()
    errs, worst_abs, moved = [], 0.0, 0.0
    for name, a, r, d, inp in zip(("x", "y", "lam", "s"), got[:4], ref[:4],
                                  r64[:4], args[7:11]):
        e, e64 = rel_err(a, r), rel_err(r, d.float())
        tol = max(TOL_ITER, min(2.0 * e64, TOL_ITER_CAP))
        check(e <= tol, f"ipm_iter {label} {name} rel {e:.3e} > {tol:.3e}")
        errs.append((name, e, e64, tol))
        worst_abs = max(worst_abs, float(torch.amax(torch.abs(a - r))))
        if name != "y":
            moved = max(moved, rel_err(r, inp) / tol)
    check(torch.equal(got[4], ref[4]), f"ipm_iter {label}: done")
    check(torch.equal(got[5], ref[5]), f"ipm_iter {label}: it")
    _, worst, _, worst_tol = max(errs, key=lambda t: t[1] / t[3])
    return dict(errs=errs, max_rel_err=worst, tol=worst_tol,
                max_abs_err=worst_abs, moved=moved,
                stepped=int((got[0] != args[7]).any(-1).sum()))


def check_ns_product(M, X, label: str) -> tuple[float, float]:
    """The Newton-Schulz refresh's first product, 2I - M X, through the
    kernel (``kernels.ns_gemm_launch``) and through ``torch.baddbmm``,
    each against the float64 product of the same float32 operands.  The
    error is taken entrywise over |M| |X|, the scale of the sum's terms (M X
    is near I, so max|2I - M X| is no scale for the rounding of a sum
    whose terms are large), and must stay under n float32 roundings.
    Returns (kernel error, baddbmm error)."""
    lib, _ = kernels.build()
    n = M.shape[-1]
    C = torch.empty_like(M)
    kernels.ns_gemm_launch(lib, kernels._stream(), M.contiguous(),
                           X.contiguous(), C, -1.0, 2.0)
    eye = torch.eye(n, device=M.device).expand_as(M)
    plain = torch.baddbmm(eye, M, X, beta=2.0, alpha=-1.0)
    ref = 2.0 * eye.double() - M.double() @ X.double()
    scale = torch.clamp_min(M.double().abs() @ X.double().abs(), 1e-300)
    err = float(torch.amax(torch.abs(C.double() - ref) / scale))
    plain_err = float(torch.amax(torch.abs(plain.double() - ref) / scale))
    tol = n * torch.finfo(torch.float32).eps / 2
    check(err <= tol, f"Newton-Schulz product {label}: error {err:.3e} of "
          f"|M||X| > {tol:.3e}")
    return err, plain_err
