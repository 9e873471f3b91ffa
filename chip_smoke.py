#!/usr/bin/env python3
"""Smoke run of bilevel_gait_gen_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path, the bilevel MPC cadence of bench.py (A1,
N=20, dt=0.05, batch 128, one gait update per 10 real-time iterations),
through ``solver.solve_step`` and ``bilevel.gait_opt_update``, and checks
it on the way:

1. device: the card, its power limit, torch/CUDA versions, TF32 flags;
2. build: compiles the three CUDA kernels from
   ``bilevel_gait_gen_tpu_torch/csrc``;
3. kernels: ``gtwg``, ``ipm_iter`` and ``gj_inverse`` on the card against
   their plain PyTorch versions at the main path's shapes (the gait update's
   512 lane problems; the exact refresh's 128 matrices of an RTI and the 512
   of the lanes' start point), ``spd_inverse`` against the Cholesky inverse
   by residual, with CUDA-event timings, each kernel's bound on this card
   and the time of the PyTorch call that computes the same function; the
   sweep is timed with its Newton-Schulz refresh and as an exact sweep
   handed its M, with its parts (M, the Newton-Schulz products, the
   iteration kernel) and ``gtwg`` and the Newton-Schulz product at both
   batches of the path (512 lanes, 128 polish problems);
4. the slice: one warm-up and two timed cadence cycles; every kernel of the
   path must have launched during it, ``gtwg`` and ``ipm_iter`` six times
   a cycle each;
5. card against CPU: two scenarios of the same cadence on the card (float32)
   and on the CPU (float64): the embedded RTI's cost within 1%, its QP
   objective and the winning lane's within what float32 allows;
6. one cadence cycle with ``qp_kernel="pallas"``, every RTI sweep through
   ``ipm_iter``;
7. the second slice: ``solver.create_initial_run`` (10 SQP iterations,
   every sweep an exact refresh) and then one cadence cycle, with
   ``ipm_inverse="gj"`` and with ``"chol"`` beside it.  Under ``"gj"`` the
   outputs must be finite, every kernel must have launched, and the run's
   one cold interior-point solve (its first SQP iteration) is held to the
   quality gate; the later iterations and the cadence cycle are outside
   the Gauss-Jordan inverse's validated range, so their solved fractions
   are printed beside the Cholesky's and not gated, with what tells where
   the scenarios are lost: the inverse's residual on every matrix of the
   run against the Cholesky's, and the run again with the Cholesky at the
   solves' start points only, then at their sweeps only.

Every phase prints its lines.  Any failed check raises, so the script exits
non-zero and prints no result; without a CUDA device it fails at once.  The
line before the last is a JSON summary of the kernels, the last line the
device record.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FREQ = 10           # one gait update per FREQ real-time iterations
BATCH = 128
TOL_GTWG = 1e-5     # max|dM| / max|M|: float32 sums of 1232 products
TOL_ITER = 1e-3     # iterate max|d| / max|ref| after one float32 sweep
                    # (or 2x the plain version's float32-vs-float64 gap)
TOL_ITER_CAP = 0.05
TOL_OBJ = 0.01      # float32 card vs float64 CPU costs
TOL_GJ = 1e-4       # max|dX| / max|X| of the Gauss-Jordan inverse (or 2x the
                    # plain version's float32-vs-float64 gap; the panel
                    # products sum in another order and the matrices are
                    # conditioned up to ~n / shift)
TOL_GJ_CAP = 0.25
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, and device-memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
DEVICE = "cuda"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bench_config():
    """The configuration of bench.py's cadence (its defaults)."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(ipm_iters=10, ipm_exact_every=5, ipm_grad_polish=2,
                     qp_kernel="xla").validate()


def cuda_ms(fn, reps: int = 10, warm: int = 2, inner: int = 1) -> float:
    """Median over ``reps`` timings of one call, each between two CUDA
    events (of ``inner`` calls in a row, divided by ``inner``: for a bare
    launch, whose host side would otherwise show in the window)."""
    import torch
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


def rel_err(got, ref) -> float:
    import torch
    scale = float(torch.amax(torch.abs(ref)))
    return float(torch.amax(torch.abs(got - ref))) / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    from bilevel_gait_gen_tpu_torch.utils.precision import set_fp32_precision
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need the card")
    set_fp32_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} fp32_matmul="
          f"{torch.get_float32_matmul_precision()}")
    return card


def phase_build():
    from bilevel_gait_gen_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    _, path = kernels.build()
    secs = time.perf_counter() - t0
    log = (path.parent / "build.log").read_text()
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] {secs:.1f} s -> {path.relative_to(REPO)}; "
          + " | ".join(usage))


def lane_qps(cfg, device):
    """The gait update's lane QPs at batch 128: the bench problem's states
    after one RTI, lanes alpha in {0, 1/3, 2/3, 1} along a projected step."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import bilevel, qp as qp_mod, solver
    from bilevel_gait_gen_tpu_torch.mpc.gait import GaitSchedule
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import Trajectory
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg, BATCH, device=device, dtype=torch.float32)
    st, _ = solver.solve_step(cfg, pr.params, pr.states, pr.x0s, pr.t0,
                              pr.feets, pr.x_des)
    grad = torch.ones_like(st.traj.sched.bounds)
    d = bilevel.contact_time_step(cfg, st.traj.sched, grad, pr.t0)
    LS = cfg.ls_alphas
    alphas = torch.arange(LS, device=device, dtype=torch.float32) / (LS - 1)

    def lanes(t):
        return torch.repeat_interleave(t, LS, dim=0)

    bounds = (st.traj.sched.bounds[:, None]
              + alphas[None, :, None, None] * d[:, None]).flatten(0, 1)
    traj = Trajectory(x_man=lanes(st.traj.x_man),
                      f_nodes=lanes(st.traj.f_nodes),
                      footholds=lanes(st.traj.footholds),
                      sched=GaitSchedule(bounds=bounds))
    return qp_mod.assemble(cfg, pr.params, traj, lanes(pr.x0s), lanes(pr.t0),
                           lanes(pr.feets), lanes(pr.x_des), lanes(st.ee_box))


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


def capture_sweeps(qp, cfg):
    """Solve the lane QPs on the fused path and keep clones of the
    arguments of kernels.ipm_iter at every sweep, the M handed over on an
    exact sweep among them (pdip sees a recording stand-in for the kernels
    module for the duration)."""
    from bilevel_gait_gen_tpu_torch.ops import kernels, pdip
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(kernels, name)

        def ipm_iter(self, *args, **kw):
            kept = {k: v.clone() if hasattr(v, "clone") else v
                    for k, v in kw.items()}
            calls.append((clone_args(args), kept))
            return kernels.ipm_iter(*args, **kw)

    pdip.kernels = Recorder()
    try:
        pdip.solve(qp.H, qp.q, qp.A, qp.b, qp.G, qp.h,
                   iters=cfg.ls_ipm_iters, tol=cfg.ipm_tol,
                   exact_every=cfg.ls_exact_every, use_pallas=True)
    finally:
        pdip.kernels = kernels
    return calls


def check_gtwg(H, G, lam, s, w_hi, reg, label):
    """gtwg against its plain version; returns (rel, abs) errors."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels
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
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels
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


def phase_kernels(cfg):
    """Each kernel against its plain version on the card, at the shapes
    the main path gives it, then both timed there."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels
    dev = torch.device(DEVICE)
    lib, _ = kernels.build()
    w_hi = 0.01 / torch.finfo(torch.float32).eps
    rows = []

    # the lane sweeps of the gait update: 512 problems [n=256, m=1280, p=16]
    qp = lane_qps(cfg, dev)
    before = kernels.gtwg.launches
    calls = capture_sweeps(qp, cfg)
    check(len(calls) == cfg.ls_ipm_iters, "one ipm_iter call per lane sweep")
    check(kernels.gtwg.launches - before == len(calls),
          "gtwg launched once per lane sweep")
    for i, (args, kw) in enumerate(calls):
        exact = not args[15]
        check((kw.get("M") is not None) == exact,
              f"lane sweep {i}: M handed over exactly on an exact sweep")
    args0, kw0 = calls[0]
    H, G, lam, s = args0[0], args0[4], args0[9], args0[10]
    reg = kw0["reg"]
    shape = (f"[{H.shape[0]}, n={H.shape[-1]}, m={G.shape[-2]}, "
             f"p={args0[2].shape[-2]}]")

    # gtwg: at the lane shape on lane data, and ragged on random data (n a
    # multiple of 4: 16-byte copies; n = 230: the scalar copies)
    err, abs_err = check_gtwg(H, G, lam, s, w_hi, reg, "lanes")
    M = kernels.gtwg(H, G, lam=lam, s=s, w_hi=w_hi, reg=reg)
    check(torch.equal(M, kw0["M"]), "gtwg gives the same M twice")
    D = kernels.gtwg(torch.zeros_like(H), G, lam=lam, s=s, w_hi=w_hi)
    check(torch.equal(D, D.mT), "G^T W G comes out exactly symmetric")
    g = torch.Generator(device=dev).manual_seed(0)
    ragged = {}
    for nr in (232, 230):
        Hr = torch.randn(BATCH, nr, nr, device=dev, generator=g)
        Gr = torch.randn(BATCH, 1232, nr, device=dev, generator=g)
        lr = torch.rand(BATCH, 1232, device=dev, generator=g) + 0.01
        sr = torch.rand(BATCH, 1232, device=dev, generator=g) + 0.01
        ragged[nr] = check_gtwg(Hr, Gr, lr, sr, w_hi, 1e-6, f"ragged n={nr}")
    t512 = time_gemms(H, G, lam, s, w_hi, reg)
    t128 = time_gemms(H[:BATCH], G[:BATCH], lam[:BATCH], s[:BATCH], w_hi, reg)
    plain = cuda_ms(lambda: kernels.gtwg_reference(
        H, G, torch.clamp(lam / s, 1.0 / w_hi, w_hi), reg))
    # the least work: the triangle of the symmetric product, B m n (n + 1)
    Bl, ml, nl = G.shape
    gtwg_flops = 1.0 * Bl * ml * nl * (nl + 1)
    gtwg_bytes = 4.0 * Bl * (2 * nl * nl + ml * nl + 2 * ml)
    bnd, by = bound_ms(gtwg_flops, gtwg_bytes)
    ns_flops = 2.0 * Bl * nl ** 3
    ns_bnd, _ = bound_ms(ns_flops, 4.0 * Bl * 3 * nl * nl)
    print(f"[kernel] gtwg {shape}: max|dM|/max|M| {err:.3e}; ragged "
          f"[{BATCH}, m=1232] n=232: {ragged[232][0]:.3e}, n=230: "
          f"{ragged[230][0]:.3e} (<= {TOL_GTWG}); G^T W G symmetric; kernel "
          f"{t512['gtwg']:.3f} ms, plain {plain:.3f} ms, baddbmm "
          f"{t512['gtwg_library']:.3f} ms, bound {bnd:.3f} ms ({by}, the "
          f"triangle); at batch {BATCH}: kernel {t128['gtwg']:.3f} ms, "
          f"baddbmm {t128['gtwg_library']:.3f} ms")
    print(f"[kernel] Newton-Schulz product [{Bl}, {nl}, {nl}]: kernel "
          f"{t512['ns_gemm']:.3f} ms, baddbmm {t512['ns_gemm_library']:.3f} "
          f"ms, bound {ns_bnd:.3f} ms; at batch {BATCH}: kernel "
          f"{t128['ns_gemm']:.3f} ms, baddbmm "
          f"{t128['ns_gemm_library']:.3f} ms")
    rows.append(dict(name="gtwg", route="cuda",
                     source="bilevel_gait_gen_tpu_torch/csrc/gtwg.cu",
                     replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:57",
                     max_abs_err=max(abs_err, ragged[232][1], ragged[230][1]),
                     ms=t512["gtwg"], plain_ms=plain, bound_ms=bnd,
                     bound_by=by, library_ms=t512["gtwg_library"],
                     ms_batch128=t128["gtwg"],
                     library_ms_batch128=t128["gtwg_library"],
                     ns_gemm_ms=t512["ns_gemm"],
                     ns_gemm_library_ms=t512["ns_gemm_library"],
                     ns_gemm_bound_ms=ns_bnd,
                     ns_gemm_ms_batch128=t128["ns_gemm"],
                     ns_gemm_library_ms_batch128=t128["ns_gemm_library"]))

    # ipm_iter: every lane sweep (exact refresh at 0-1, handed its M as the
    # solver hands it; Newton-Schulz at 2-3).  The tolerance: 1e-3 of
    # max|ref|, or twice the plain version's own distance to the same sweep
    # computed in float64 (M too) where float32 is less accurate than that
    # (cold-start sweeps on these matrices are), never more than
    # TOL_ITER_CAP.
    worst_abs = 0.0
    for i, (args, kw) in enumerate(calls):
        kw64 = {k: v for k, v in kw.items() if k != "M"}
        got = kernels.ipm_iter(*clone_args(args), **kw)
        ref = kernels.ipm_iter_reference(*clone_args(args), **kw)
        r64 = kernels.ipm_iter_reference(*to_float64(args), **kw64)
        torch.cuda.synchronize()
        errs = []
        for name, a, r, d in zip(("x", "y", "lam", "s"), got[:4], ref[:4],
                                 r64[:4]):
            e, e64 = rel_err(a, r), rel_err(r, d.float())
            tol = max(TOL_ITER, min(2.0 * e64, TOL_ITER_CAP))
            check(e <= tol,
                  f"ipm_iter sweep {i} {name} rel {e:.3e} > {tol:.3e}")
            errs.append(f"{name} {e:.1e} (f32 vs f64 {e64:.1e})")
            worst_abs = max(worst_abs, float(torch.amax(torch.abs(a - r))))
        check(torch.equal(got[4], ref[4]), f"ipm_iter sweep {i}: done")
        check(torch.equal(got[5], ref[5]), f"ipm_iter sweep {i}: it")
        moved = int((got[0] != args[7]).any(-1).sum())
        print(f"[kernel] ipm_iter sweep {i} do_ns={int(args[15])} {shape}: "
              f"{', '.join(errs)}; done/it identical; {moved} of "
              f"{got[0].shape[0]} problems stepped")

    # times: the sweep with its Newton-Schulz refresh (sweep 2) and the exact
    # sweep handed its M (sweep 0); only what a sweep writes is cloned inside
    # the window
    args, kw = calls[2]
    ms = cuda_ms(lambda: kernels.ipm_iter(*fresh_state(args), **kw))
    plain = cuda_ms(lambda: kernels.ipm_iter_reference(*fresh_state(args),
                                                       **kw))
    ms_exact = cuda_ms(lambda: kernels.ipm_iter(*fresh_state(args0), **kw0))
    plain_exact = cuda_ms(lambda: kernels.ipm_iter_reference(
        *fresh_state(args0), **kw0))
    # the parts of the chain as bare launches: M, the four Newton-Schulz
    # products, the iteration kernel (on a state it updates in place)
    stream = kernels._stream()
    Hc, q, A, b, Gc, h, ga, x, y, lam2, s2, done, it, best, Mi_in, _ = (
        fresh_state(args))
    M2, T, X = (torch.empty_like(Hc) for _ in range(3))

    def launch_m():
        kernels.gtwg_launch(lib, stream, Hc, Gc, None, lam2, s2, M2, reg,
                            1.0 / w_hi, w_hi)

    def launch_ns():
        Mi = Mi_in
        for _ in range(kw["ns_steps"]):
            kernels.ns_gemm_launch(lib, stream, M2, Mi, T, -1.0, 2.0)
            kernels.ns_gemm_launch(lib, stream, Mi, T, X, 1.0, 0.0)
            Mi = X

    done_i = done.to(torch.int32)
    parts = dict(
        M=cuda_ms(launch_m, inner=3), ns_products=cuda_ms(launch_ns, inner=3),
        iteration=cuda_ms(lambda: kernels.ipm_iter_launch(
            lib, stream, Hc, q, A, b, Gc, h, ga, M2, Mi_in, x, y, lam2, s2,
            *best, done_i, it, reg=reg, tol=kw["tol"],
            refine_steps=kw["refine_steps"]), inner=3))
    # least work of a sweep with the Newton-Schulz refresh: the triangle of
    # M, 2 products per NS step, then the iteration's matrix-vector work (two
    # directions with one refinement each: ~22 n^2 + 12 m n + 2 p n^2 per
    # problem); it reads H, G, A, Mi and the vectors once and writes Mi and
    # the vectors.  The exact sweep handed its M has the last part only and
    # reads M too.
    pl_ = args[2].shape[-2]
    iter_flops = Bl * (22.0 * nl * nl + 12.0 * ml * nl + 2.0 * pl_ * nl * nl)
    it_flops = gtwg_flops + kw["ns_steps"] * 2 * ns_flops + iter_flops
    it_bytes = 4.0 * Bl * (3 * nl * nl + ml * nl + pl_ * nl
                           + 4 * (nl + pl_ + 2 * ml) + 3 * ml)
    bnd, by = bound_ms(it_flops, it_bytes)
    bnd_exact, by_exact = bound_ms(iter_flops, it_bytes)
    print(f"[kernel] ipm_iter sweep (do_ns=1) {shape}: kernel chain "
          f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.3f} ms ({by}); "
          f"exact sweep handed its M: chain {ms_exact:.3f} ms, plain "
          f"{plain_exact:.3f} ms, bound {bnd_exact:.3f} ms ({by_exact}); "
          f"parts as bare launches: M {parts['M']:.3f} ms, "
          f"{2 * kw['ns_steps']} Newton-Schulz products "
          f"{parts['ns_products']:.3f} ms, iteration kernel "
          f"{parts['iteration']:.3f} ms; no single PyTorch call computes a "
          f"sweep")
    rows.append(dict(name="ipm_iter", route="cuda",
                     source="bilevel_gait_gen_tpu_torch/csrc/ipm_iter.cu",
                     replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:155",
                     max_abs_err=worst_abs, ms=ms, plain_ms=plain,
                     bound_ms=bnd, bound_by=by, library_ms=None,
                     ms_exact_sweep=ms_exact, plain_ms_exact_sweep=plain_exact,
                     bound_ms_exact_sweep=bnd_exact,
                     bound_by_exact_sweep=by_exact, parts_ms=parts))
    rows.append(check_gj_inverse(cfg, qp))
    return rows


def with_spd_inverse(wrap, fn) -> None:
    """Run ``fn`` with ``kernels.spd_inverse`` replaced by ``wrap(spd)``,
    ``spd`` being the real one; restored after."""
    from bilevel_gait_gen_tpu_torch.ops import kernels
    spd = kernels.spd_inverse
    kernels.spd_inverse = wrap(spd)
    try:
        fn()
    finally:
        kernels.spd_inverse = spd


def watch_spd_inverse(fn, on_call) -> None:
    """Run ``fn`` with ``on_call(M, X)`` called after every
    ``X = kernels.spd_inverse(M)`` made meanwhile."""
    def wrap(spd):
        def watched(M, **kw):
            X = spd(M, **kw)
            on_call(M, X)
            return X
        return watched

    with_spd_inverse(wrap, fn)


def capture_spd_inputs(fn):
    """Run ``fn`` and return clones of the matrix batches handed to
    kernels.spd_inverse meanwhile."""
    spd_in = []
    watch_spd_inverse(fn, lambda M, X: spd_in.append(M.clone()))
    return spd_in


def gj_input(M, shift: float = 1e-3):
    """What spd_inverse hands to gj_inverse for M: scaled, padded, shifted."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels
    Mp, _ = kernels.spd_scale_pad(M)
    return Mp + shift * torch.eye(Mp.shape[-1], device=M.device)


def spd_residuals(M, X=None):
    """max|M X - I| per matrix for X = spd_inverse(M) (or the X given) and
    for the Cholesky inverse: (r [B], r_chol [B])."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels, pdip
    eye = torch.eye(M.shape[-1], device=M.device)
    if X is None:
        X = kernels.spd_inverse(M)
    r = torch.amax(torch.abs(M @ X - eye), dim=(-2, -1))
    rc = torch.amax(torch.abs(M @ pdip._chol_inverse(M) - eye), dim=(-2, -1))
    return r, rc


def within_chol_bound(r, rc):
    """The bound of the JAX package's tests, per matrix:
    r < 20 * max(r_chol, 1e-6)."""
    import torch
    return r < 20.0 * torch.clamp_min(rc, 1e-6)


def check_gj_inverse(cfg, lane_qp):
    """gj_inverse against its plain version (at the kernel's block width) on
    matrices of the path: a cold RTI solve's start point and exact sweeps at
    [128, 232 -> 256] and the lanes' start point at [512, 256]; spd_inverse
    whole against the Cholesky inverse by residual on the cold matrices."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import qp as qp_mod
    from bilevel_gait_gen_tpu_torch.ops import kernels, pdip
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg, BATCH, device=DEVICE, dtype=torch.float32)
    rq = qp_mod.assemble(cfg, pr.params, pr.states.traj, pr.x0s, pr.t0,
                         pr.feets, pr.x_des, pr.states.ee_box)
    rti_spd = capture_spd_inputs(lambda: pdip.solve(
        rq.H, rq.q, rq.A, rq.b, rq.G, rq.h, iters=cfg.ipm_iters,
        tol=cfg.ipm_tol, exact_every=cfg.ipm_exact_every, use_pallas=False,
        inverse="gj"))
    n_exact = 1 + sum(i < 2 or i % cfg.ipm_exact_every == 0
                      for i in range(cfg.ipm_iters))
    check(len(rti_spd) == n_exact, f"{n_exact} spd_inverse calls per cold "
          f"RTI solve, got {len(rti_spd)}")
    rti_in = [gj_input(M) for M in rti_spd]
    lane_spd = capture_spd_inputs(lambda: pdip.solve(
        lane_qp.H, lane_qp.q, lane_qp.A, lane_qp.b, lane_qp.G, lane_qp.h,
        iters=cfg.ls_ipm_iters, tol=cfg.ipm_tol,
        exact_every=cfg.ls_exact_every, use_pallas=True, inverse="gj"))
    check(len(lane_spd) == 1, "the fused path inverts only its start point "
          "through spd_inverse")
    lane_in = [gj_input(lane_spd[0])]

    w = kernels.GJ_BLOCK
    worst_abs = 0.0
    for label, Mk in (("RTI start point", rti_in[0]),
                      ("RTI sweep 0", rti_in[1]),
                      (f"RTI sweep {cfg.ipm_exact_every}", rti_in[-1]),
                      ("lane start point", lane_in[0])):
        before = kernels.gj_inverse.launches
        X = kernels.gj_inverse(Mk)
        torch.cuda.synchronize()
        check(kernels.gj_inverse.launches == before + 1, "one launch counted")
        ref = kernels.gj_inverse_reference(Mk, w=w)
        r64 = kernels.gj_inverse_reference(Mk.double(), w=w).float()
        e, e64 = rel_err(X, ref), rel_err(ref, r64)
        tol = max(TOL_GJ, min(2.0 * e64, TOL_GJ_CAP))
        eye = torch.eye(Mk.shape[-1], device=Mk.device)
        res_k = float(torch.amax(torch.abs(Mk @ X - eye)))
        res_p = float(torch.amax(torch.abs(Mk @ ref - eye)))
        check(bool(torch.isfinite(X).all()), f"gj_inverse {label}: finite")
        check(e <= tol, f"gj_inverse {label}: rel {e:.3e} > {tol:.3e}")
        check(res_k <= 3.0 * res_p + 1e-5,
              f"gj_inverse {label}: residual {res_k:.3e} vs plain {res_p:.3e}")
        worst_abs = max(worst_abs, float(torch.amax(torch.abs(X - ref))))
        print(f"[kernel] gj_inverse {label} {list(Mk.shape)} w={w}: "
              f"max|dX|/max|X| {e:.3e} (<= {tol:.3e}; plain f32 vs f64 "
              f"{e64:.3e}); residual max|MX-I| kernel {res_k:.3e}, plain "
              f"{res_p:.3e}")

    # spd_inverse whole on the cold matrices, by residual, with the bound of
    # the JAX package's tests: r < 20 * max(r_chol, 1e-6) per matrix
    for label, M in (("start point", rti_spd[0]), ("sweep 0", rti_spd[1])):
        r, rc = spd_residuals(M)
        ok = within_chol_bound(r, rc)
        print(f"[kernel] spd_inverse cold RTI {label} {list(M.shape)}: "
              f"residual max {float(r.max()):.3e}, median "
              f"{float(r.median()):.3e} (Cholesky max {float(rc.max()):.3e}, "
              f"median {float(rc.median()):.3e}); {int(ok.sum())} of "
              f"{ok.numel()} within 20 x max(Cholesky, 1e-6)")
        check(bool(ok.all()), f"spd_inverse {label} residual bound")

    # times at the RTI shape (and the kernel at the lanes' too)
    Mk, M = rti_in[1], rti_spd[1]
    ms = cuda_ms(lambda: kernels.gj_inverse(Mk))
    ms_lane = cuda_ms(lambda: kernels.gj_inverse(lane_in[0]))
    plain = cuda_ms(lambda: kernels.gj_inverse_reference(Mk, w=w), reps=3,
                    warm=1)
    spd_ms = cuda_ms(lambda: kernels.spd_inverse(M))
    spd_nodefl = cuda_ms(lambda: kernels.spd_inverse(M, deflate=0))
    chol_ms = cuda_ms(lambda: pdip._chol_inverse(M))
    cholinv_ms = cuda_ms(lambda: torch.cholesky_inverse(
        torch.linalg.cholesky_ex(M).L))
    inv_ms = cuda_ms(lambda: torch.linalg.inv(Mk))
    Bk, nk = Mk.shape[0], Mk.shape[-1]
    bnd, by = bound_ms(2.0 * Bk * nk ** 3, 4.0 * Bk * 2 * nk * nk)
    print(f"[kernel] gj_inverse [{Bk}, {nk}, {nk}]: kernel {ms:.3f} ms "
          f"([{lane_in[0].shape[0]}, {nk}, {nk}]: {ms_lane:.3f} ms), plain "
          f"{plain:.3f} ms, torch.linalg.inv {inv_ms:.3f} ms, bound "
          f"{bnd:.4f} ms ({by}; the kernel's real limit is its chain of "
          f"{nk} dependent pivot steps); spd_inverse whole at "
          f"{list(M.shape)} {spd_ms:.3f} ms, of which deflation "
          f"{spd_ms - spd_nodefl:.3f} ms; pdip._chol_inverse {chol_ms:.3f} ms"
          f", cholesky_ex + cholesky_inverse {cholinv_ms:.3f} ms")
    return dict(name="gj_inverse", route="cuda",
                source="bilevel_gait_gen_tpu_torch/csrc/gj_inverse.cu",
                replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:456",
                max_abs_err=worst_abs, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=inv_ms, ms_lane_start=ms_lane,
                spd_inverse_ms=spd_ms, spd_deflation_ms=spd_ms - spd_nodefl,
                chol_inverse_ms=chol_ms)


def run_cadence(cfg, pr, cycles):
    """``cycles`` cadence cycles: FREQ-1 RTIs, then one gait update.
    Returns (state, per-cycle seconds, RTI solved flags, gait results)."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import bilevel, solver
    st = pr.states
    secs, solved, gres = [], [], []
    for _ in range(cycles):
        if pr.x0s.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        flags = []
        for _ in range(FREQ - 1):
            st, stats = solver.solve_step(cfg, pr.params, st, pr.x0s, pr.t0,
                                          pr.feets, pr.x_des)
            flags.append(stats.solved)
        res = bilevel.gait_opt_update(cfg, pr.params, st, pr.x0s, pr.t0,
                                      pr.feets, pr.x_des)
        st = res.state
        if pr.x0s.is_cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        solved.append(torch.stack(flags))
        gres.append(res)
    return st, secs, solved, gres


def solved_fraction(solved, gres) -> float:
    fr = [float(s.float().mean()) * (FREQ - 1) / FREQ
          + float(r.rti_stats.solved.float().mean()) / FREQ
          for s, r in zip(solved, gres)]
    return float(np.mean(fr))


def all_finite(st, gres) -> bool:
    import torch
    tensors = [st.traj.x_man, st.traj.f_nodes, st.traj.footholds,
               st.traj.sched.bounds, st.ee_box]
    for r in gres:
        tensors += [r.rti_stats.cost, r.trust, r.grad_norm]
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def phase_slice(cfg):
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg, BATCH, device=DEVICE, dtype=torch.float32)
    kernels.reset_launch_counts()
    st, secs, solved, gres = run_cadence(cfg, pr, cycles=3)
    launches = {"gtwg": kernels.gtwg.launches,
                "ipm_iter": kernels.ipm_iter.launches}
    check(kernels.gj_inverse.launches == 0,
          'ipm_inverse="chol" never reaches gj_inverse')
    timed = secs[1:]
    cyc = float(np.mean(timed))
    frac = solved_fraction(solved[1:], gres[1:])
    accept = float(torch.cat([r.accepted for r in gres[1:]]).float().mean())
    finite = all_finite(st, gres)
    check(finite, "every output of the cadence is finite")
    check(tuple(st.traj.x_man.shape) == (BATCH, cfg.num_nodes + 1, 13),
          "trajectory shape")
    check(frac >= 0.95, f"solved_frac {frac:.4f} >= 0.95")
    # per cycle: 4 lane sweeps and 2 polish sweeps, each one ipm_iter launch
    # and one gtwg launch (an exact sweep's M is formed once and handed on)
    for name, n in launches.items():
        check(n == 6 * 3, f"{name}: {n} launches in 3 cycles, not 6 a cycle")
    print(f"[slice] batch {BATCH}, N={cfg.num_nodes}, FREQ={FREQ}: "
          f"{BATCH * FREQ / cyc:.1f} solves/s, {cyc * 1e3:.1f} ms/cycle "
          f"(cycles {', '.join(f'{s * 1e3:.1f}' for s in secs)} ms, first "
          f"is warm-up); solved_frac {frac:.4f}; gait accept rate "
          f"{accept:.3f}; all finite {finite}; launches {launches}")
    return launches, frac, cyc


def phase_card_vs_cpu(cfg):
    """Two scenarios, one cycle, on the card in float32 and on the CPU in
    float64 (and float32, the plain path's own precision).  The embedded
    RTI's trajectory cost is held to 1% of float64, the bound
    tests/test_parity.py holds the JAX package's float32 rollout to.  The QP
    objectives (the embedded RTI's and the winning lane's) are only as
    accurate as the float32 solves' quality gate; they are held to 1% or to
    twice the CPU float32 path's own distance from float64, whichever is
    larger."""
    import torch
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    out = {}
    for key, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu32", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        pr = make_problem(cfg, 2, device=dev, dtype=dtype)
        _, _, _, gres = run_cadence(cfg, pr, cycles=1)
        r = gres[0]
        out[key] = {name: v.double().cpu() for name, v in (
            ("rti_cost", r.rti_stats.cost), ("rti_obj", r.rti_obj),
            ("win_obj", r.win_obj))}

    def rel(a, b):
        return torch.abs(a - b) / torch.clamp_min(torch.abs(b), 1.0)

    parts = []
    for name in ("rti_cost", "rti_obj", "win_obj"):
        card, c32, c64 = (out[k][name] for k in ("card", "cpu32", "cpu64"))
        check(bool((torch.isfinite(card) == torch.isfinite(c64)).all()),
              f"{name}: the same scenarios finite on card and CPU")
        fin = torch.isfinite(c64)
        err = rel(card[fin], c64[fin])
        if name == "rti_cost":
            tol = torch.full_like(err, TOL_OBJ)
        else:
            tol = torch.clamp_min(2.0 * rel(c32[fin], c64[fin]), TOL_OBJ)
        parts.append(f"{name} card {card.tolist()} cpu64 {c64.tolist()} "
                     f"cpu32 {c32.tolist()} rel {err.tolist()} "
                     f"limit {tol.tolist()}")
        check(bool((err <= tol).all()), f"card vs CPU {name}")
    print("[card-vs-cpu] 2 scenarios, 1 cycle: " + "; ".join(parts))


def phase_rti_kernel(cfg):
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    cfg_k = dataclasses.replace(cfg, qp_kernel="pallas")
    pr = make_problem(cfg_k, BATCH, device=DEVICE, dtype=torch.float32)
    before = kernels.ipm_iter.launches
    st, secs, solved, gres = run_cadence(cfg_k, pr, cycles=1)
    frac = solved_fraction(solved, gres)
    check(kernels.ipm_iter.launches - before
          >= (FREQ - 1) * cfg.ipm_iters, "RTI sweeps went through ipm_iter")
    check(all_finite(st, gres), "every output finite with RTI kernels")
    print(f"[rti-kernel] qp_kernel='pallas', 1 cycle (includes its first "
          f"call): {secs[0] * 1e3:.1f} ms, solved_frac {frac:.4f}")


def initial_run(cfg, pr):
    """``solver.create_initial_run`` on the problem, with the solved flags of
    each of its SQP iterations recorded on the way (a recording stand-in for
    ``solver.solve_step`` for the duration).  Returns (state, last stats,
    seconds, solved fraction per iteration)."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import solver
    step = solver.solve_step
    flags = []

    def rec_step(*args, **kw):
        out = step(*args, **kw)
        flags.append(out[1].solved)
        return out

    solver.solve_step = rec_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, stats = solver.create_initial_run(cfg, pr.params, pr.states,
                                              pr.x0s, pr.feets, pr.x_des,
                                              pr.t0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        solver.solve_step = step
    return st, stats, secs, [float(f.float().mean()) for f in flags]


def phase_cold_start_gj(cfg):
    """The second slice: create_initial_run, then one cadence cycle, with
    ``ipm_inverse="gj"``; the same under "chol" beside it.

    Gated under "gj": finite outputs, launches of every kernel, and the
    quality gate (solved fraction >= 0.95) of the first SQP iteration, the
    one cold interior-point solve of the run.  The JAX package validates its
    Gauss-Jordan inverse on cold matrices only and says that warm-started
    solves fail their gate under it, so the solved fractions of the later
    iterations and of the cadence cycle are printed beside the Cholesky's,
    not gated.  What tells where the scenarios are lost is printed too: the
    inverse's residual against the Cholesky's on every matrix of the run, by
    iteration, and the run with the Cholesky at the start point of every
    solve only, then at the sweeps only.  Returns the launch counts of the
    "gj" path."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels, pdip
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    out = {}
    for inv in ("chol", "gj"):
        cfg_i = dataclasses.replace(cfg, ipm_inverse=inv)
        pr = make_problem(cfg_i, BATCH, device=DEVICE, dtype=torch.float32)
        kernels.reset_launch_counts()
        st, stats, init_s, fracs = initial_run(cfg_i, pr)
        init_gj = kernels.gj_inverse.launches
        st2, secs, solved, gres = run_cadence(
            cfg_i, dataclasses.replace(pr, states=st), cycles=1)
        launches = {"gtwg": kernels.gtwg.launches,
                    "ipm_iter": kernels.ipm_iter.launches,
                    "gj_inverse": kernels.gj_inverse.launches}
        init_finite = all(bool(torch.isfinite(t).all()) for t in (
            st.traj.x_man, st.traj.f_nodes, st.traj.footholds, stats.cost))
        out[inv] = dict(init_frac=float(stats.solved.float().mean()),
                        fracs=fracs, init_s=init_s, init_gj=init_gj,
                        init_cost=float(stats.cost[stats.solved].median()),
                        cyc_frac=solved_fraction(solved, gres),
                        cyc_s=secs[0], launches=launches,
                        finite=init_finite and all_finite(st2, gres))
        check(len(fracs) == cfg.init_run_iters, "one solve_step per SQP "
              "iteration of the initial run")
        check(tuple(st.traj.x_man.shape) == (BATCH, cfg.num_nodes + 1, 13),
              "trajectory shape after the initial run")
    for inv, r in out.items():
        print(f"[cold-start] ipm_inverse={inv!r} batch {BATCH}: "
              f"create_initial_run ({cfg.init_run_iters} SQP iterations) "
              f"{r['init_s'] * 1e3:.1f} ms, solved_frac by iteration "
              f"{[round(f, 4) for f in r['fracs']]}, median cost of the "
              f"solved {r['init_cost']:.4f}, gj_inverse launches "
              f"{r['init_gj']}; then 1 cadence cycle {r['cyc_s'] * 1e3:.1f} "
              f"ms, solved_frac {r['cyc_frac']:.4f}; all finite "
              f"{r['finite']}; launches {r['launches']}")

    # where the Gauss-Jordan refresh loses the Cholesky's residual: the same
    # run once more, every spd_inverse result of every sweep held against the
    # Cholesky inverse of the same matrices, by SQP iteration
    per_it = 1 + cfg.ipm_iters
    cfg_gj = dataclasses.replace(cfg, ipm_inverse="gj")
    pr = make_problem(cfg_gj, BATCH, device=DEVICE, dtype=torch.float32)
    trace = []
    fracs = []
    watch_spd_inverse(
        lambda: fracs.extend(initial_run(cfg_gj, pr)[3]),
        lambda M, X: trace.append(spd_residuals(M, X)))
    check(len(trace) == cfg.init_run_iters * per_it, "every sweep of the "
          "initial run is an exact refresh through spd_inverse")
    for it in range(cfg.init_run_iters):
        r, rc = (torch.stack(t) for t in
                 zip(*trace[it * per_it:(it + 1) * per_it]))    # [11, B]
        both = torch.isfinite(r) & torch.isfinite(rc)
        bad = both & ~within_chol_bound(r, rc)
        print(f"[cold-start] iteration {it} under 'gj', {per_it} spd_inverse "
              f"calls x {BATCH} scenarios: solved_frac {fracs[it]:.4f}; "
              f"residual max {float(r[both].max()):.3e}, median "
              f"{float(r[both].median()):.3e} (Cholesky max "
              f"{float(rc[both].max()):.3e}, median "
              f"{float(rc[both].median()):.3e}); outside 20 x max(Cholesky, "
              f"1e-6): {int(bad.sum())} of {int(both.sum())} matrices, in "
              f"{int(bad.any(0).sum())} scenarios; not finite: spd_inverse "
              f"{int((~torch.isfinite(r)).sum())}, Cholesky "
              f"{int((~torch.isfinite(rc)).sum())}")

    # which of the two uses loses the scenarios: the run again with the
    # Cholesky inverse in place of spd_inverse at the Mehrotra start point of
    # every solve (call 0 of each iteration), then at its sweeps instead
    for label, use_chol in (
            ("the start point of every solve (Gauss-Jordan at the sweeps)",
             lambda k: k % per_it == 0),
            ("every sweep (Gauss-Jordan at the start point)",
             lambda k: k % per_it != 0)):
        calls = itertools.count()
        mixed = []
        with_spd_inverse(
            lambda spd: lambda M, **kw: (
                pdip._chol_inverse(M) if use_chol(next(calls))
                else spd(M, **kw)),
            lambda: mixed.extend(initial_run(cfg_gj, pr)[3]))
        print(f"[cold-start] 'gj' with the Cholesky inverse at {label}: "
              f"solved_frac by iteration {[round(f, 4) for f in mixed]}")

    gj = out["gj"]
    check(out["chol"]["launches"]["gj_inverse"] == 0,
          '"chol" never reaches gj_inverse')
    check(gj["init_gj"] == len(trace), "one gj_inverse launch per exact "
          "refresh of the initial run")
    check(gj["finite"], 'every output finite under ipm_inverse="gj"')
    check(out["chol"]["init_frac"] >= 0.95,
          f'cold start under "chol": solved_frac '
          f'{out["chol"]["init_frac"]:.4f} >= 0.95')
    check(gj["fracs"][0] >= 0.95,
          f'cold solve under "gj": solved_frac {gj["fracs"][0]:.4f} >= 0.95 '
          f'("chol": {out["chol"]["fracs"][0]:.4f})')
    for name, n in gj["launches"].items():
        check(n > 0, f'{name} launched on the "gj" path')
    return gj["launches"]


def main() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need the card")
    check((REPO / "bilevel_gait_gen_tpu_torch").is_dir(),
          "run from a checkout of the repository")
    phase_device()
    phase_build()
    cfg = bench_config()
    rows = phase_kernels(cfg)
    launches, _, _ = phase_slice(cfg)
    phase_card_vs_cpu(cfg)
    phase_rti_kernel(cfg)
    gj_launches = phase_cold_start_gj(cfg)
    # launches: gtwg and ipm_iter from the "chol" cadence (phase 4),
    # gj_inverse from the cold start + cycle under "gj" (phase 7); both
    # paths' counts are kept beside them
    for row in rows:
        name = row["name"]
        row["launches"] = launches.get(name, gj_launches[name])
        row["launches_by_path"] = {"chol_cadence": launches.get(name, 0),
                                   "gj_cold_start": gj_launches[name]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
