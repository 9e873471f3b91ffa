#!/usr/bin/env python3
"""Bring-up smoke run of bilevel_gait_gen_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path, the bilevel MPC cadence of bench.py (A1,
N=20, dt=0.05, batch 128, one gait update per 10 real-time iterations),
through ``solver.solve_step`` and ``bilevel.gait_opt_update``, and checks
it on the way:

1. device: the card, its power limit, torch/CUDA versions, TF32 flags;
2. build: compiles the CUDA kernels from ``bilevel_gait_gen_tpu_torch/csrc``;
3. kernels: ``gtwg`` and ``ipm_iter`` on the card against their plain
   PyTorch versions at the main path's shapes (the gait update's 512 lane
   problems), with CUDA-event timings;
4. the slice: one warm-up and two timed cadence cycles; every kernel of the
   path must have launched during it;
5. card against CPU: two scenarios of the same cadence on the card (float32)
   and on the CPU (float64): the embedded RTI's cost within 1%, its QP
   objective and the winning lane's within what float32 allows;
6. one cadence cycle with ``qp_kernel="pallas"``, every RTI sweep through
   ``ipm_iter``.

Every phase prints one line.  Any failed check raises, so the script exits
non-zero and prints no result; without a CUDA device it fails at once.  The
line before the last is a JSON summary of the kernels, the last line the
device record.
"""
from __future__ import annotations

import dataclasses
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
DEVICE = "cuda"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bench_config():
    """The configuration of bench.py's cadence (its defaults)."""
    from bilevel_gait_gen_tpu.utils.config import MPCConfig
    return MPCConfig(ipm_iters=10, ipm_exact_every=5, ipm_grad_polish=2,
                     qp_kernel="xla").validate()


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def to_float64(args):
    """Float64 copies of a captured ipm_iter call (for the plain version)."""
    return [tuple(b.double() if b.is_floating_point() else b.clone()
                  for b in a) if isinstance(a, tuple)
            else (a.double() if a.is_floating_point() else a.clone())
            if hasattr(a, "clone") else a for a in args]


def capture_sweeps(qp, cfg):
    """Solve the lane QPs on the fused path and keep clones of the
    arguments of kernels.ipm_iter at every sweep (pdip sees a recording
    stand-in for the kernels module for the duration)."""
    from bilevel_gait_gen_tpu_torch.ops import kernels, pdip
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(kernels, name)

        def ipm_iter(self, *args, **kw):
            calls.append((clone_args(args), dict(kw)))
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


def phase_kernels(cfg):
    """Each kernel against its plain version on the card, at the shapes
    the main path gives it, then both timed there."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernels
    dev = torch.device(DEVICE)
    w_hi = 0.01 / torch.finfo(torch.float32).eps
    rows = []

    # the lane sweeps of the gait update: 512 problems [n=256, m=1280, p=16]
    qp = lane_qps(cfg, dev)
    calls = capture_sweeps(qp, cfg)
    check(len(calls) == cfg.ls_ipm_iters, "one ipm_iter call per lane sweep")
    args0, kw0 = calls[0]
    H, G, lam, s = args0[0], args0[4], args0[9], args0[10]
    shape = (f"[{H.shape[0]}, n={H.shape[-1]}, m={G.shape[-2]}, "
             f"p={args0[2].shape[-2]}]")

    # gtwg: at the lane shape on lane data, and ragged on random data
    err, abs_err = check_gtwg(H, G, lam, s, w_hi, kw0["reg"], "lanes")
    g = torch.Generator(device=dev).manual_seed(0)
    Hr = torch.randn(BATCH, 232, 232, device=dev, generator=g)
    Gr = torch.randn(BATCH, 1232, 232, device=dev, generator=g)
    lr = torch.rand(BATCH, 1232, device=dev, generator=g) + 0.01
    sr = torch.rand(BATCH, 1232, device=dev, generator=g) + 0.01
    err_r, abs_r = check_gtwg(Hr, Gr, lr, sr, w_hi, 1e-6, "ragged")
    ms = cuda_ms(lambda: kernels.gtwg(H, G, lam=lam, s=s, w_hi=w_hi,
                                      reg=kw0["reg"]))
    plain = cuda_ms(lambda: kernels.gtwg_reference(
        H, G, torch.clamp(lam / s, 1.0 / w_hi, w_hi), kw0["reg"]))
    print(f"[kernel] gtwg {shape}: max|dM|/max|M| {err:.3e}; ragged "
          f"[{BATCH}, n=232, m=1232]: {err_r:.3e} (<= {TOL_GTWG}); kernel "
          f"{ms:.3f} ms, plain {plain:.3f} ms")
    rows.append(dict(name="gtwg", route="cuda",
                     source="bilevel_gait_gen_tpu_torch/csrc/gtwg.cu",
                     replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:57",
                     max_abs_err=max(abs_err, abs_r), ms=ms, plain_ms=plain))

    # ipm_iter: every lane sweep (exact refresh at 0-1, Newton-Schulz at
    # 2-3).  The tolerance: 1e-3 of max|ref|, or twice the plain version's
    # own distance to the same sweep computed in float64 where float32 is
    # less accurate than that (cold-start sweeps on these matrices are),
    # never more than TOL_ITER_CAP.
    worst_abs = 0.0
    for i, (args, kw) in enumerate(calls):
        got = kernels.ipm_iter(*clone_args(args), **kw)
        ref = kernels.ipm_iter_reference(*clone_args(args), **kw)
        r64 = kernels.ipm_iter_reference(*to_float64(args), **kw)
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
    args, kw = calls[2]
    ms = cuda_ms(lambda: kernels.ipm_iter(*clone_args(args), **kw))
    plain = cuda_ms(lambda: kernels.ipm_iter_reference(*clone_args(args),
                                                       **kw))
    print(f"[kernel] ipm_iter sweep (do_ns=1) {shape}: kernel chain "
          f"{ms:.3f} ms, plain {plain:.3f} ms")
    rows.append(dict(name="ipm_iter", route="cuda",
                     source="bilevel_gait_gen_tpu_torch/csrc/ipm_iter.cu",
                     replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:155",
                     max_abs_err=worst_abs, ms=ms, plain_ms=plain))
    return rows


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
    timed = secs[1:]
    cyc = float(np.mean(timed))
    frac = solved_fraction(solved[1:], gres[1:])
    accept = float(torch.cat([r.accepted for r in gres[1:]]).float().mean())
    finite = all_finite(st, gres)
    check(finite, "every output of the cadence is finite")
    check(tuple(st.traj.x_man.shape) == (BATCH, cfg.num_nodes + 1, 13),
          "trajectory shape")
    check(frac >= 0.95, f"solved_frac {frac:.4f} >= 0.95")
    for name, n in launches.items():
        check(n > 0, f"{name} launched during the cadence")
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


def main() -> int:
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
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
