"""Checks, timings and bounds of the hand-written kernels on the card,
shared by ``chip_smoke.py`` and ``bench_torch.py``; ``record_kernel_calls``
and ``check_recorded_calls`` hold the kernels at the shapes and on the data
that a run of the path gives them; ``profile_call`` gives a call's device
busy share.

Each kernel is held to its plain PyTorch version (``kernels.*_reference``)
on the same inputs with the tolerances below, timed between CUDA events,
and set beside its bound on an H100: the larger of its operations over the
float32 peak and its bytes over the memory rate.
"""
from __future__ import annotations

import time

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


def profile_call(call, label: str) -> dict:
    """One call under ``torch.profiler`` after an untraced one: the
    device's busy time (the union of its kernels' and copies' intervals)
    against the call's wall time, and the kernels by total time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict[str, list] = {}
    for e in dev:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e3
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    window = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    res = {"wall_ms": wall, "device_busy_ms": busy / 1e3,
           "device_window_ms": window, "device_ops": len(dev),
           "busy_share_of_wall": busy / 1e3 / wall,
           "top": [[n, ms, k] for n, (ms, k) in top]}
    print(f"[profile] {label}: wall {wall:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / 1e3 / wall:.1f}% of wall), "
          f"{len(dev)} device operations; by time: "
          + "; ".join(f"{n[:60]} {ms:.2f} ms x{k}" for n, ms, k in res["top"]),
          flush=True)
    return res


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


def handed_sweep_bytes(B: int, m: int, n: int, p: int,
                       refine_steps: int) -> dict[str, float]:
    """Bytes of one sweep of ``ipm_iter.cu::ipm_iter_handed_kernel`` at
    [B, n, m, p]: ``bound``, its inputs (H, M, Mi, G, A, A Mi, S^-1 and the
    vectors) read once and its outputs written once; ``design``, what its
    passes read (H once, G five times, M once a refinement, and per KKT
    solve, two a direction and one more a refinement: Mi once, A Mi twice,
    S^-1 once; A once in the residuals and once a refinement);
    ``first_version``, the passes of the kernel before it was handed A Mi
    (per KKT solve Mi twice and A twice, A twice in the residuals and twice
    a refinement, and the same passes over H, G, M and S^-1)."""
    nn, mn, pn, pp = n * n, m * n, p * n, p * p
    vecs = 4 * (n + p + 2 * m) + 3 * m
    solves = 2 * (1 + refine_steps)
    per = dict(
        bound=3 * nn + mn + 2 * pn + pp + vecs,
        design=(nn + 5 * mn + 2 * refine_steps * nn
                + solves * (nn + 2 * pn + pp)
                + (1 + 2 * refine_steps) * pn + vecs),
        first_version=(nn + 5 * mn + 2 * refine_steps * nn
                       + solves * (2 * nn + 2 * pn + pp)
                       + (2 + 4 * refine_steps) * pn + vecs))
    return {k: 4.0 * B * v for k, v in per.items()}


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
    _, worst, worst64, worst_tol = max(errs, key=lambda t: t[1] / t[3])
    return dict(errs=errs, max_rel_err=worst, tol=worst_tol,
                f32_vs_f64=worst64,
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


def record_kernel_calls(fn) -> dict:
    """Run ``fn`` with a recording stand-in for the kernels module in
    ``ops/pdip.py``; returns, per kernel and shape, clones of the arguments
    of the first call (``gtwg`` as the exact sweeps call it, ``ipm_iter``
    by refresh and with or without the M handed over)."""
    from bilevel_gait_gen_tpu_torch.ops import pdip
    calls = {}

    def keep(key, args, kw):
        if key not in calls:
            calls[key] = (clone_args(args),
                          {k: v.clone() if hasattr(v, "clone") else v
                           for k, v in kw.items()})

    class Recorder:
        def __getattr__(self, name):
            return getattr(kernels, name)

        def gtwg(self, H, G, *args, **kw):
            keep(("gtwg", tuple(G.shape)), (H, G), kw)
            return kernels.gtwg(H, G, *args, **kw)

        def ipm_iter(self, *args, **kw):
            keep(("ipm_iter", tuple(args[4].shape), bool(args[15]),
                  kw.get("M") is not None), args, kw)
            return kernels.ipm_iter(*args, **kw)

    pdip.kernels = Recorder()
    try:
        fn()
    finally:
        pdip.kernels = kernels
    return calls


def check_ns_live(exact, label: str) -> dict:
    """The lanes' Newton-Schulz sweeps take no step on the path's own data
    (batch 1, 8, the N=50 lanes) or almost none (batch 128): the refresh of
    their ill-conditioned M diverges in float32, the plain version's as the
    kernel's, and the sweep refuses the step.  So that the comparison sees
    a sweep that moves, this runs the same chain at the same shape on the
    inputs of the exact sweep (``exact``: its recorded arguments): as a
    Newton-Schulz sweep that forms its own M and takes the exact inverse as
    its refresh (0 products), which must move the iterate by more than the
    tolerance; and the refresh's product on that M and inverse, held to the
    float64 product.  Returns the row's fields."""
    args, kw = exact
    args = list(args)
    args[15] = True
    kw = {k: v for k, v in kw.items() if k != "M"} | {"ns_steps": 0}
    c = compare_ipm_iter(args, kw, f"{label} live")
    check(c["moved"] > 1.0,
          f"ipm_iter {label}: on the exact sweep's inputs the plain "
          f"version moves the iterate by {c['moved']:.2f} of the tolerance")
    err, plain_err = check_ns_product(exact[1]["M"], exact[0][14], label)
    return dict(live_max_rel_err=c["max_rel_err"], live_tol=c["tol"],
                live_moved_over_tol=c["moved"], ns_product_err=err,
                ns_product_plain_err=plain_err)


def check_recorded_calls(calls: dict, label: str) -> list[dict]:
    """Each kernel call recorded by :func:`record_kernel_calls` held to the
    kernel's plain version (the tolerances above; an exact ``ipm_iter``
    sweep must move its iterate by more than its tolerance, so that the
    comparison could see a kernel that wrote nothing, and a Newton-Schulz
    sweep that does not is also checked by :func:`check_ns_live`) and
    timed, with its bound and, for ``gtwg``, the ``torch.baddbmm`` call that
    computes the same product.  Prints and returns one row per kernel and
    shape."""
    rows = []
    w_hi = 0.01 / torch.finfo(torch.float32).eps
    for key, (args, kw) in calls.items():
        if key[0] == "gtwg":
            H, G = args
            lam, s, reg = kw["lam"], kw["s"], kw["reg"]
            err, abs_err = check_gtwg(H, G, lam, s, w_hi, reg,
                                      f"{label} {list(G.shape)}")
            t = time_gemms(H, G, lam, s, w_hi, reg)
            W = torch.clamp(lam / s, 1.0 / w_hi, w_hi)
            plain = cuda_ms(lambda: kernels.gtwg_reference(H, G, W, reg))
            B, m, n = G.shape
            bnd, by = bound_ms(*gtwg_work(B, m, n))
            ns_bnd, ns_by = bound_ms(2.0 * B * n ** 3, 4.0 * B * 3 * n * n)
            rows.append(dict(kernel="gtwg", config=label,
                             shape=[B, n, m], max_rel_err=err,
                             max_abs_err=abs_err, tol=TOL_GTWG,
                             ms=t["gtwg"], plain_ms=plain, bound_ms=bnd,
                             bound_by=by, library_ms=t["gtwg_library"],
                             ns_gemm_ms=t["ns_gemm"],
                             ns_gemm_library_ms=t["ns_gemm_library"],
                             ns_gemm_bound_ms=ns_bnd,
                             ns_gemm_bound_by=ns_by))
            continue
        _, shape, do_ns, handed_m = key
        c = compare_ipm_iter(args, kw, f"{label} {list(shape)}")
        live = {}
        if c["moved"] <= 1.0:
            check(do_ns, f"ipm_iter {label} {list(shape)}: the exact "
                  f"sweep moves the iterate by {c['moved']:.2f} of the "
                  f"tolerance, too little for the comparison to count")
            live = check_ns_live(calls["ipm_iter", shape, False, True],
                                 f"{label} {list(shape)}")
        ms = cuda_ms(lambda: kernels.ipm_iter(*fresh_state(args), **kw))
        plain = cuda_ms(lambda: kernels.ipm_iter_reference(
            *fresh_state(args), **kw))
        B, m, n = shape
        p = args[2].shape[-2]
        flops, iter_flops, nbytes = sweep_work(
            B, m, n, p, kw["ns_steps"] if do_ns else 0)
        bnd, by = bound_ms(flops if not handed_m else iter_flops, nbytes)
        rows.append(dict(kernel="ipm_iter", config=label, shape=[B, n, m, p],
                         refresh="newton-schulz" if do_ns else "exact",
                         handed_m=handed_m, max_rel_err=c["max_rel_err"],
                         max_abs_err=c["max_abs_err"], tol=c["tol"],
                         f32_vs_f64=c["f32_vs_f64"], moved_over_tol=c["moved"],
                         stepped=c["stepped"],
                         ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=None, **live))
    for r in rows:
        print(f"[kernel] {r['kernel']} {label} {r['shape']}"
              + (f" {r['refresh']} refresh" if "refresh" in r else "")
              + (", handed M" if r.get("handed_m") else "")
              + (f" ({r['stepped']} of {r['shape'][0]} problems stepped, "
                 f"the plain version moved {r['moved_over_tol']:.2f}x tol"
                 + (f"; live: the sweep on the exact sweep's inputs rel "
                    f"{r['live_max_rel_err']:.2e} (<= {r['live_tol']:.2e}, "
                    f"moved {r['live_moved_over_tol']:.1f}x tol), the NS "
                    f"product {r['ns_product_err']:.2e} of |M||X| "
                    f"(baddbmm {r['ns_product_plain_err']:.2e})"
                    if "live_tol" in r else "") + ")"
                 if "stepped" in r else "")
              + f": max rel err {r['max_rel_err']:.2e} (<= {r['tol']:.2e}"
              + (f"; the plain version float32 vs float64 "
                 f"{r['f32_vs_f64']:.2e}" if "f32_vs_f64" in r else "")
              + "); "
              f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})"
              + (f", baddbmm {r['library_ms']:.3f} ms"
                 if r["library_ms"] is not None else "")
              + (f"; the Newton-Schulz product [{r['shape'][0]}, "
                 f"{r['shape'][1]}, {r['shape'][1]}]: kernel "
                 f"{r['ns_gemm_ms']:.3f} ms, baddbmm "
                 f"{r['ns_gemm_library_ms']:.3f} ms, bound "
                 f"{r['ns_gemm_bound_ms']:.3f} ms ({r['ns_gemm_bound_by']})"
                 if "ns_gemm_ms" in r else ""), flush=True)
    return rows
