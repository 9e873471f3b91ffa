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
   512 lane problems; the exact refresh's 128 matrices of an RTI, 232 rows
   padded to 256, in the resident form that ``n_valid`` selects and in the
   streaming form, and the 512 of the lanes' start point in the streaming
   form), ``spd_inverse`` against the Cholesky inverse
   by residual, with CUDA-event timings, each kernel's bound on this card
   and the time of the PyTorch call that computes the same function; the
   sweep is timed with its Newton-Schulz refresh and as an exact sweep
   handed its M, with its parts (M, the Newton-Schulz products, the
   iteration kernel) and ``gtwg`` and the Newton-Schulz product at both
   batches of the path (512 lanes, 128 polish problems);
4. the slice: one warm-up and two timed cadence cycles
   (``mpc/cadence.cycle``, eagerly); every kernel of the path must have
   launched during it, ``gtwg`` and ``ipm_iter`` six times a cycle each;
   then the same cycle and one RTI captured as CUDA graphs
   (``utils/graphs.Graphed``), replayed from the same state and held to
   the eager run bit for bit, six launches of each kernel counted at the
   capture, eager and graphed ms a cycle printed;
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
   solves' start points only, then at their sweeps only;
8. the closed loop (``sim/engine.closed_loop``): the flagship loop of
   tests/test_sim_engine.py (penalty-ground physics, the 1 kHz whole-body
   torque QP, MPC real-time iterations, the gait update every fifth MPC
   update, a mistimed trot) at batch 128 for 300 ticks, each kind of MPC
   period replayed as a CUDA graph; every log entry finite and every base
   above 0.15 m; each period's replay against its eager run bit for bit,
   ``gtwg`` and ``ipm_iter`` launched by the gait period (none by the RTI
   period) and held to their plain versions at its shapes; two scenarios
   of one period on the card (float32) against the CPU (float64); eager
   and graphed ms per period and per control tick, ticks/s and the
   aggregate real-time factor;
9. the centroidal RTI (``mpc/centroidal.py``): the JAX package's centroidal
   acceptance configuration (N=20, 18 sweeps, the force carrier, the
   settled stand, the standing gait) at batch 128, joints moved by 0.01
   rad: ``create_initial_run_centroidal`` and ten shifting
   ``solve_centroidal_step``s through ``gtwg`` at [128, 512, 1792] and the
   p = 256 ``ipm_iter`` chain (its Schur stage ``rgemm`` and
   ``chol_inverse``, then ``ipm_iter_handed_kernel``), launches counted;
   each kernel held to its plain version on one step's calls and timed
   (the handed kernel also alone, beside its bytes bound); one step
   replayed as a CUDA graph bit for bit; card against CPU from one float64
   plan;
10. the ADMM backend (``qp_backend="admm"``, 1600 iterations a QP) on the
   bench problem at batch 128, float64: an RTI block eagerly and as a
   graph replay, bit for bit, beside the interior-point block; card
   against CPU;
11. the other robot families at batch 128: the Adam biped under its
   shipped ``configs/adam_march.yaml`` (lanes [512, 128, 640, p=28]) and
   the Mini Cheetah under bench.py's configuration: the cold start and one
   cadence cycle, eagerly and as a graph replay bit for bit, solved_frac
   >= 0.95, launches counted (no Schur stage at p <= 32); the kernels held
   to their plain versions at Adam's shapes and timed; card against CPU;
12. the hardware loop: scripts/hardware_sim_demo.py --trot at batch 1,
   float32: ``control.hardware.HardwareRobot`` in ``Mode.MPC`` over a
   loopback ``runtime.UdpEndpoint`` pair, its control_fn the port's MPC
   (an RTI every 50 ticks, the gait update in place of every second, the
   1 kHz ``control_action_full``; each a CUDA graph), the robot side the
   port's penalty-ground engine with the motor PD law, 250 ticks in
   lockstep: finite commands, no fall-back to Stand, upright; ``gtwg`` and
   ``ipm_iter`` launched by the gait update and held to their plain
   versions on its calls; the stats ring, the LowLevelLog, a checkpoint and
   a ``torch.profiler`` trace checked; card against CPU on the first MPC
   period's commands; a free-running ``HardwareRobot.run`` at 1 kHz
   (ticks, overruns, latency printed);
13. the golden contract (``golden.rollout``, the counterpart of
   scripts/parity_tpu.py): the initial SQP, 10 RTIs and the outer gradient
   of scripts/gen_golden.py in float32 on the card, held to
   tests/golden/a1_trot.npz at parity_tpu.py's cost and cosine bounds and
   at tests/test_parity.py's float32 bounds, dx (not gated), dc and cos
   printed beside the CPU float32 rollout's;
14. the closed-loop harness: ``sim/closed_loop.ClosedLoopController`` (the
   controller of ``run_closed_loop``) in float32 on the card at
   ``run_push_recovery``'s configuration and start, the gait update every
   fifth MPC tick, 1.0 s at 1 kHz with a push at 0.5 s, behind the port's
   penalty-ground engine in MuJoCo's place (the card's machine has no
   MuJoCo): finite torques, upright, every graph held to its eager first
   use; the gait update's QP has p = 56 equality rows (the Raibert rows),
   so it launches ``gtwg``, ``ipm_iter``, the Schur stage (``rgemm``,
   ``chol_inverse``) and ``ipm_iter_handed_kernel``, each held to its plain
   version on the update's own calls; card against CPU on the first 250
   ticks; n_mpc, n_fails, n_gait_accepts, mpc_ms and ctrl_ms printed;
15. the demos (``scripts/torch_*.py``; the three MuJoCo demos need MuJoCo,
   which the card's machine lacks): torch_mpc_demo.py's path at full width
   (the initial run, 20 RTIs and the gait update, each a CUDA graph held to
   its eager first call; the gait update's ``gtwg`` and ``ipm_iter`` calls
   held to their plain versions; the final plan against the CPU float64
   run within 10x the CPU float32 gap); torch_batch_sim_demo.py's defaults
   (100 ticks at mpc_every=12, so a trailing partial period) graphed by
   ``engine.closed_loop`` against its periods run eagerly, bit for bit;
   torch_batch_sim_demo.py --big at batch 128 (real-time factor, upright
   count); torch_diag_engine.py at 500 ticks (its trace, finite);
16. ``parallel/`` (``mesh``, ``multihost`` over ``torch.distributed``) and
   the four scripts on it: the alpha-sharded gait update at bench width
   (batch 128, ``ls_alphas=4``) in two ``gloo`` processes that share the
   card, each solving its half of the lanes ([256, 256, 1280, p=16] a
   rank), held to the update without a group (alpha equal outside float32
   ties, cost rtol 1e-3, bounds atol 2e-3), each rank's ``gtwg`` and
   ``ipm_iter`` calls held to their plain versions and counted; the same
   function in a one-rank ``nccl`` group, bit for bit; the
   scenario-sharded closed loop in two processes of 64 scenarios against
   the unsharded loop (tests/test_parallel.py:171-199's contract), each
   rank bit for bit its own rerun and the unsharded loop of its 64
   scenarios; torch_multihost_demo.py on the card; torch_distr_rejection.py
   at batch 256; torch_bench_sweep.py at batches 128 and 1024 for both QP
   kernels.  The children are fresh interpreters (``--parallel-rank``),
   started after this process built the kernels.

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

from bilevel_gait_gen_tpu_torch.ops.kernel_checks import (
    TOL_GTWG, bound_ms, check, check_gtwg, clone_args, compare_ipm_iter,
    cuda_ms, fresh_state, gtwg_work, rel_err, sweep_work, time_gemms)

REPO = Path(__file__).resolve().parent
FREQ = 10           # one gait update per FREQ real-time iterations
BATCH = 128
TOL_OBJ = 0.01      # float32 card vs float64 CPU costs
TOL_GJ = 1e-4       # max|dX| / max|X| of the Gauss-Jordan inverse (or 2x the
                    # plain version's float32-vs-float64 gap; the panel
                    # products sum in another order and the matrices are
                    # conditioned up to ~n / shift)
TOL_GJ_CAP = 0.25
DEVICE = "cuda"


def bench_config():
    """The configuration of bench.py's cadence (its defaults)."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(ipm_iters=10, ipm_exact_every=5, ipm_grad_polish=2,
                     qp_kernel="xla").validate()


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
    Wl = torch.clamp(lam / s, 1.0 / w_hi, w_hi)
    plain = cuda_ms(lambda: kernels.gtwg_reference(H, G, Wl, reg))
    plain128 = cuda_ms(lambda: kernels.gtwg_reference(
        H[:BATCH], G[:BATCH], Wl[:BATCH], reg))
    # the least work: the triangle of the symmetric product
    Bl, ml, nl = G.shape
    bnd, by = bound_ms(*gtwg_work(Bl, ml, nl))
    ns_flops = 2.0 * Bl * nl ** 3
    ns_bnd, _ = bound_ms(ns_flops, 4.0 * Bl * 3 * nl * nl)
    print(f"[kernel] gtwg {shape}: max|dM|/max|M| {err:.3e}; ragged "
          f"[{BATCH}, m=1232] n=232: {ragged[232][0]:.3e}, n=230: "
          f"{ragged[230][0]:.3e} (<= {TOL_GTWG}); G^T W G symmetric; kernel "
          f"{t512['gtwg']:.3f} ms, plain {plain:.3f} ms, baddbmm "
          f"{t512['gtwg_library']:.3f} ms, bound {bnd:.3f} ms ({by}, the "
          f"triangle); at batch {BATCH}: kernel {t128['gtwg']:.3f} ms, "
          f"plain {plain128:.3f} ms, baddbmm {t128['gtwg_library']:.3f} ms")
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
                     ms_batch128=t128["gtwg"], plain_ms_batch128=plain128,
                     library_ms_batch128=t128["gtwg_library"],
                     ns_gemm_ms=t512["ns_gemm"],
                     ns_gemm_library_ms=t512["ns_gemm_library"],
                     ns_gemm_bound_ms=ns_bnd,
                     ns_gemm_ms_batch128=t128["ns_gemm"],
                     ns_gemm_library_ms_batch128=t128["ns_gemm_library"]))

    # ipm_iter: every lane sweep (exact refresh at 0-1, handed its M as the
    # solver hands it; Newton-Schulz at 2-3), with compare_ipm_iter's
    # tolerances
    worst_abs = 0.0
    for i, (args, kw) in enumerate(calls):
        c = compare_ipm_iter(args, kw, f"sweep {i}")
        worst_abs = max(worst_abs, c["max_abs_err"])
        errs = [f"{name} {e:.1e} (f32 vs f64 {e64:.1e})"
                for name, e, e64, _ in c["errs"]]
        print(f"[kernel] ipm_iter sweep {i} do_ns={int(args[15])} {shape}: "
              f"{', '.join(errs)}; done/it identical; {c['stepped']} of "
              f"{args[7].shape[0]} problems stepped")

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
    launch_m()
    it_args = (Hc, q, A, b, Gc, h, ga, M2, Mi_in, x, y, lam2, s2, *best,
               done_i, it)

    def launch_iteration(batch):
        # the first ``batch`` problems: the polish runs the kernel at 128
        kernels.ipm_iter_launch(
            lib, stream, *(t[:batch] for t in it_args), reg=reg,
            tol=kw["tol"], refine_steps=kw["refine_steps"])

    parts = dict(
        M=cuda_ms(launch_m, inner=3), ns_products=cuda_ms(launch_ns, inner=3),
        iteration=cuda_ms(lambda: launch_iteration(Hc.shape[0]), inner=3),
        iteration_batch128=cuda_ms(lambda: launch_iteration(BATCH), inner=3))
    # least work of a sweep (sweep_work)
    it_flops, iter_flops, it_bytes = sweep_work(Bl, ml, nl, args[2].shape[-2],
                                                kw["ns_steps"])
    bnd, by = bound_ms(it_flops, it_bytes)
    bnd_exact, by_exact = bound_ms(iter_flops, it_bytes)
    bnd_it128, by_it128 = bound_ms(iter_flops * BATCH / Bl,
                                   it_bytes * BATCH / Bl)
    print(f"[kernel] ipm_iter sweep (do_ns=1) {shape}: kernel chain "
          f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.3f} ms ({by}); "
          f"exact sweep handed its M: chain {ms_exact:.3f} ms, plain "
          f"{plain_exact:.3f} ms, bound {bnd_exact:.3f} ms ({by_exact}); "
          f"parts as bare launches: M {parts['M']:.3f} ms, "
          f"{2 * kw['ns_steps']} Newton-Schulz products "
          f"{parts['ns_products']:.3f} ms, iteration kernel "
          f"{parts['iteration']:.3f} ms (at batch {BATCH}: "
          f"{parts['iteration_batch128']:.3f} ms, bound {bnd_it128:.3f} ms, "
          f"{by_it128}); no single PyTorch call computes a sweep")
    rows.append(dict(name="ipm_iter", route="cuda",
                     source="bilevel_gait_gen_tpu_torch/csrc/ipm_iter.cu",
                     replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:155",
                     max_abs_err=worst_abs, ms=ms, plain_ms=plain,
                     bound_ms=bnd, bound_by=by, library_ms=None,
                     ms_exact_sweep=ms_exact, plain_ms_exact_sweep=plain_exact,
                     bound_ms_exact_sweep=bnd_exact,
                     bound_by_exact_sweep=by_exact,
                     bound_ms_iteration_batch128=bnd_it128, parts_ms=parts))
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
    [128, 232 -> 256], told n_valid=232 (resident form) and not told
    (streaming form), and the lanes' start point at [512, 256] (streaming
    form); spd_inverse whole against the Cholesky inverse by residual on the
    cold matrices."""
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
    n_rti = rti_spd[0].shape[-1]
    lib, _ = kernels.build()
    # the RTI matrices are n_rti rows padded to 256: told so, the wrapper
    # takes the resident form; not told, the streaming form, as it does for
    # the lanes' start point, whose 256 rows are all real
    for label, Mk, nv in (
            ("RTI start point", rti_in[0], n_rti),
            ("RTI sweep 0", rti_in[1], n_rti),
            (f"RTI sweep {cfg.ipm_exact_every}", rti_in[-1], n_rti),
            ("RTI start point", rti_in[0], None),
            ("RTI sweep 0", rti_in[1], None),
            (f"RTI sweep {cfg.ipm_exact_every}", rti_in[-1], None),
            ("lane start point", lane_in[0], None)):
        nk = Mk.shape[-1]
        form = kernels.gj_form(lib, nk, nv or nk)
        check(form == ("resident" if nv else "streaming"),
              f"gj_inverse {label} n_valid={nv}: form {form}")
        before = kernels.gj_inverse.launches
        X = kernels.gj_inverse(Mk, n_valid=nv)
        torch.cuda.synchronize()
        check(kernels.gj_inverse.launches == before + 1, "one launch counted")
        ref = kernels.gj_inverse_reference(Mk, w=w)
        r64 = kernels.gj_inverse_reference(Mk.double(), w=w).float()
        e, e64 = rel_err(X, ref), rel_err(ref, r64)
        tol = max(TOL_GJ, min(2.0 * e64, TOL_GJ_CAP))
        eye = torch.eye(nk, device=Mk.device)
        res_k = float(torch.amax(torch.abs(Mk @ X - eye)))
        res_p = float(torch.amax(torch.abs(Mk @ ref - eye)))
        check(bool(torch.isfinite(X).all()), f"gj_inverse {label}: finite")
        check(e <= tol, f"gj_inverse {label}: rel {e:.3e} > {tol:.3e}")
        check(res_k <= 3.0 * res_p + 1e-5,
              f"gj_inverse {label}: residual {res_k:.3e} vs plain {res_p:.3e}")
        if nv:
            check(torch.equal(X[:, nv:], ref[:, nv:])
                  and torch.equal(X[:, :, nv:], ref[:, :, nv:]),
                  f"gj_inverse {label}: the tail from {nv} on is the padded "
                  f"computation's, bit for bit")
        worst_abs = max(worst_abs, float(torch.amax(torch.abs(X - ref))))
        print(f"[kernel] gj_inverse {label} {list(Mk.shape)} n_valid={nv} "
              f"({form}) w={w}: max|dX|/max|X| {e:.3e} (<= {tol:.3e}; plain "
              f"f32 vs f64 {e64:.3e}); residual max|MX-I| kernel "
              f"{res_k:.3e}, plain {res_p:.3e}")

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

    # times at the RTI shape in both forms, and at the lanes' shape
    Mk, M = rti_in[1], rti_spd[1]
    ms = cuda_ms(lambda: kernels.gj_inverse(Mk, n_valid=n_rti))
    ms_stream = cuda_ms(lambda: kernels.gj_inverse(Mk))
    ms_lane = cuda_ms(lambda: kernels.gj_inverse(lane_in[0]))
    plain = cuda_ms(lambda: kernels.gj_inverse_reference(Mk, w=w), reps=3,
                    warm=1)
    spd_ms = cuda_ms(lambda: kernels.spd_inverse(M))
    spd_nodefl = cuda_ms(lambda: kernels.spd_inverse(M, deflate=0))
    chol_ms = cuda_ms(lambda: pdip._chol_inverse(M))
    cholinv_ms = cuda_ms(lambda: torch.cholesky_inverse(
        torch.linalg.cholesky_ex(M).L))
    inv_ms = cuda_ms(lambda: torch.linalg.inv(Mk))
    inv_lane_ms = cuda_ms(lambda: torch.linalg.inv(lane_in[0]))
    Bk, nk, Bl = Mk.shape[0], Mk.shape[-1], lane_in[0].shape[0]
    # the work these inputs need: the n_rti real rows, the output whole
    bnd, by = bound_ms(2.0 * Bk * n_rti ** 3,
                       4.0 * Bk * (n_rti * n_rti + nk * nk))
    bnd_pad, _ = bound_ms(2.0 * Bk * nk ** 3, 4.0 * Bk * 2 * nk * nk)
    bnd_lane, by_lane = bound_ms(2.0 * Bl * nk ** 3, 4.0 * Bl * 2 * nk * nk)
    print(f"[kernel] gj_inverse [{Bk}, {n_rti} -> {nk}, {nk}]: resident form "
          f"{ms:.3f} ms (one block per matrix: {Bk} blocks fill {Bk} of the "
          f"card's SMs once), streaming form (not told n_valid) "
          f"{ms_stream:.3f} ms, plain {plain:.3f} ms, torch.linalg.inv "
          f"{inv_ms:.3f} ms, bound {bnd:.4f} ms ({by}, 2 n^3 at n={n_rti}; "
          f"{bnd_pad:.4f} ms at the padded n={nk}; the kernel's real limit "
          f"is its chain of {-(-n_rti // w)} dependent block steps); "
          f"[{Bl}, {nk}, {nk}] streaming form {ms_lane:.3f} ms, "
          f"torch.linalg.inv {inv_lane_ms:.3f} ms, bound {bnd_lane:.4f} ms "
          f"({by_lane}); spd_inverse whole at {list(M.shape)} {spd_ms:.3f} "
          f"ms, of which deflation {spd_ms - spd_nodefl:.3f} ms; "
          f"pdip._chol_inverse {chol_ms:.3f} ms, cholesky_ex + "
          f"cholesky_inverse {cholinv_ms:.3f} ms")
    return dict(name="gj_inverse", route="cuda",
                source="bilevel_gait_gen_tpu_torch/csrc/gj_inverse.cu",
                replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:456",
                max_abs_err=worst_abs, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=inv_ms, bound_ms_padded=bnd_pad,
                ms_streaming_form=ms_stream, ms_lane_start=ms_lane,
                bound_ms_lane_start=bnd_lane,
                library_ms_lane_start=inv_lane_ms,
                spd_inverse_ms=spd_ms, spd_deflation_ms=spd_ms - spd_nodefl,
                chol_inverse_ms=chol_ms)


def run_cadence(cfg, pr, cycles):
    """``cycles`` cadence cycles (``cadence.cycle``: FREQ-1 RTIs, then one
    gait update), eagerly.  Returns (state, per-cycle seconds, RTI solved
    flags, gait results)."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import cadence
    st = pr.states
    secs, solved, gres = [], [], []
    for _ in range(cycles):
        if pr.x0s.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, flags, res, _ = cadence.cycle(cfg, pr.params, st,
                                          *pr.loop_args()[1:], FREQ)
        if pr.x0s.is_cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        solved.append(flags)
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


def leaf_distances(a, b) -> list[float]:
    """For each pair of tensors of two result trees: 0 where their bits are
    the same (NaNs included), else max|a - b| (inf for integers and flags
    that differ)."""
    import torch
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
    out = []
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.dtype in as_int:
            same = x.dtype == y.dtype and torch.equal(
                x.view(as_int[x.dtype]), y.view(as_int[y.dtype]))
        else:
            same = torch.equal(x, y)
        if same:
            out.append(0.0)
        elif x.is_floating_point():
            out.append(float(torch.amax(torch.abs(
                torch.nan_to_num(x.double()) - torch.nan_to_num(y.double())))))
        else:
            out.append(float("inf"))
    return out


def phase_graphs(cfg):
    """The cadence as CUDA graphs (``utils/graphs.Graphed``).  From one
    batch-128 state after a warm cycle: one captured cycle and one captured
    RTI, each replayed and held to the eager ``cadence.cycle`` /
    ``cadence.rti_block`` on the same state and inputs bit for bit on every
    output; where two eager runs differ themselves, the replay is held to
    their distance instead.  The capture counts the kernels' launches: six
    of gtwg and six of ipm_iter a cycle.  Eager and graphed ms a cycle are
    printed.  Returns the cycle's captured launches."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import cadence
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
    pr = make_problem(cfg, BATCH, device=DEVICE, dtype=torch.float32)
    st = run_cadence(cfg, pr, cycles=1)[0]
    rest = pr.loop_args()[1:]
    loops = {
        "cycle": lambda s, *a: cadence.cycle(cfg, pr.params, s, *a, FREQ),
        "RTI": lambda s, *a: cadence.rti_block(cfg, pr.params, s, *a, 1)}
    launches, lines = None, []
    for name, fn in loops.items():
        t0 = time.perf_counter()
        g = Graphed(fn, st, *rest)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        eager1 = fn(st, *rest)
        eager2 = fn(st, *rest)
        got = g()
        torch.cuda.synchronize()
        d_ge = leaf_distances(got, eager1)
        d_ee = leaf_distances(eager2, eager1)
        bitwise = not any(d_ge)
        if not bitwise:
            check(any(d_ee), f"graphed {name}: {sum(map(bool, d_ge))} "
                  f"outputs differ from the eager run (max {max(d_ge):.3e}) "
                  f"though two eager runs agree bit for bit")
            check(all(g_ <= e_ for g_, e_ in zip(d_ge, d_ee)),
                  f"graphed {name} further from eager than two eager runs")
        eager_ms, graph_ms = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(st, *rest)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            g()
            torch.cuda.synchronize()
            graph_ms.append((time.perf_counter() - t0) * 1e3)
        if name == "cycle":
            launches = dict(g.captured_launches)
            for kname in ("gtwg", "ipm_iter"):
                check(launches[kname] == 6, f"the captured cycle launches "
                      f"{kname} {launches[kname]} times, not 6")
        lines.append(
            f"{name}: capture (2 warm-up calls included) {capture_s:.1f} s; "
            f"replay vs eager "
            + ("bit for bit on all" if bitwise else
               f"within the eager-vs-eager distance on all")
            + f" {len(d_ge)} outputs (eager vs eager: "
            f"{sum(map(bool, d_ee))} differ); ms eager "
            f"{', '.join(f'{t:.1f}' for t in eager_ms)}, graphed "
            f"{', '.join(f'{t:.1f}' for t in graph_ms)}"
            + (f"; captured launches {launches}" if name == "cycle" else ""))
        g.close()
        del g
    print(f"[graphs] batch {BATCH}: " + "; ".join(lines), flush=True)
    return launches


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
    "gj" path, and gj_inverse's by form."""
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
        init_forms = dict(kernels.gj_inverse.launches_by_form)
        st2, secs, solved, gres = run_cadence(
            cfg_i, dataclasses.replace(pr, states=st), cycles=1)
        launches = {"gtwg": kernels.gtwg.launches,
                    "ipm_iter": kernels.ipm_iter.launches,
                    "gj_inverse": kernels.gj_inverse.launches}
        init_finite = all(bool(torch.isfinite(t).all()) for t in (
            st.traj.x_man, st.traj.f_nodes, st.traj.footholds, stats.cost))
        out[inv] = dict(init_frac=float(stats.solved.float().mean()),
                        fracs=fracs, init_s=init_s, init_gj=init_gj,
                        init_forms=init_forms,
                        forms=dict(kernels.gj_inverse.launches_by_form),
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
              f"{r['init_gj']} {r['init_forms']}; then 1 cadence cycle "
              f"{r['cyc_s'] * 1e3:.1f} ms, solved_frac {r['cyc_frac']:.4f}; "
              f"all finite {r['finite']}; launches {r['launches']}, "
              f"gj_inverse by form {r['forms']}")

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
    for form in ("resident", "streaming"):
        check(gj["forms"][form] > 0,
              f'gj_inverse launched in its {form} form on the "gj" path')
    return gj["launches"], gj["forms"]


# ---------------------------------------------------------------------------
# phase 8: the closed loop
# ---------------------------------------------------------------------------

LOOP_BATCH = 128
LOOP_TICKS = 300        # 6 MPC periods; the gait update at tick 250 (cut
                        # from 550 to keep the script near 300 s)
MPC_EVERY = 50
GAIT_EVERY = 5
CONTROL_DT = 0.001
LOOP_PERT = 0.01        # rad, the joints' perturbation per scenario
# card (float32) against CPU (float64), one RTI period from one plan: held
# to 10x the CPU float32 run's own distance from float64 on the same inputs
# (the card sums in other orders, and the loop amplifies rounding: the
# torques switch between their bounds within 25 ticks), and at least to
TOL_TAU = 0.01          # N m, the first tick's torques
TOL_BASE = 1e-4         # m, the period's base positions


def loop_configs():
    """The flagship closed loop of tests/test_sim_engine.py::
    test_closed_loop_bilevel_trot_3s: (MPCConfig, WBQPConfig, SimConfig)."""
    from bilevel_gait_gen_tpu_torch.control.wbqp import WBQPConfig
    from bilevel_gait_gen_tpu_torch.sim.engine import SimConfig
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    cfg = MPCConfig(ipm_iters=18, force_carrier=True, double_support=0.15,
                    carrier_ramp=0.15, swing_height=0.05,
                    ls_alphas=4).validate()
    return cfg, WBQPConfig(torque_bound=30.0), SimConfig()


def loop_start(cfg, sim, batch: int, device, dtype):
    """The flagship's start, batch first: the settled stand, a trot with
    every phase bound stretched x1.25 (mistimed, so that the gait update has
    something to fix), create_initial_run once, then ``batch`` scenarios of
    that plan whose joints are moved by LOOP_PERT * N(0, 1) from a seeded
    numpy generator (scripts/batch_sim_demo.py draws with jax.random).
    Returns (model, params, state, q0 [B, nq], v0 [B, nv], x_des [B, 12])."""
    import torch
    from bilevel_gait_gen_tpu_torch.control import mpc_controller
    from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
    from bilevel_gait_gen_tpu_torch.mpc import gait, solver
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
    from bilevel_gait_gen_tpu_torch.sim import engine
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    model = a1.make_a1(device=device)
    stand = torch.tensor(a1.stand_config(), dtype=dtype, device=device)
    q0 = engine.settled_stand(model, sim, stand)
    params = srb.make_srb_params(model, q0)
    x0 = mpc_controller.reconstruct_srb_state(model, params, q0,
                                              torch.zeros_like(q0[1:]))
    feet0 = rbd.ee_positions(model, q0)
    sched = gait.GaitSchedule(bounds=gait.make_trot(
        cfg, dtype=dtype, device=device).bounds * 1.25)
    traj = default_trajectory(cfg, sched, x0[None], feet0[None, :, :2])
    st = solver.make_state(cfg, traj, torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    x_des = srb.manifold_to_tangent(x0)[None]
    st, stats = solver.create_initial_run(cfg, params, st, x0[None],
                                          feet0[None], x_des)
    check(bool(stats.solved.all()), "the closed loop's initial run solved")
    dq = LOOP_PERT * np.random.default_rng(0).standard_normal(
        (batch, model.num_joints))
    q0s = q0.expand(batch, -1) + torch.cat([
        torch.zeros(batch, 7, dtype=dtype, device=device),
        torch.tensor(dq, dtype=dtype, device=device)], dim=-1)
    states = tree_map(lambda a: a.expand(batch, *a.shape[1:]).clone(), st)
    return (model, params, states, q0s,
            torch.zeros(batch, model.nv, dtype=dtype, device=device),
            x_des.expand(batch, -1).clone())


def timed_ms(fn, *args):
    """(fn(*args), milliseconds between two synchronizations)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_bitwise(got, want, what: str) -> int:
    """Every output of ``got`` equal to ``want`` bit for bit (NaNs
    included); returns how many outputs were compared."""
    d = leaf_distances(got, want)
    check(not any(d), f"{what}: {sum(map(bool, d))} of {len(d)} outputs "
          f"differ (max {max(d):.3e})")
    return len(d)


def phase_closed_loop(card: str):
    """Phase 8: the flagship closed loop (penalty-ground physics, the 1 kHz
    torque QP, MPC real-time iterations, the gait update every fifth MPC
    update) at batch 128 for LOOP_TICKS ticks, float32 on the card.

    1. ``engine.closed_loop``, the entry point, with the kernels' counts set
       to 0 before and read after: it captures one CUDA graph of an RTI
       period and one of a gait period and replays them; ``gtwg`` and
       ``ipm_iter`` must have launched (at the gait graph's warm-up and
       capture); every log entry finite (the cost where an MPC update ran),
       base z above 0.15 m in every scenario; the solved share of the MPC
       updates and the change of the phase lengths printed, not gated.
    2. The two periods as graphs against their eager runs, bit for bit: the
       RTI period from tick 0 (no kernel launched at its capture), replayed
       on to tick 250, then the gait period from there (both kernels
       launched at its capture); the kernels held to their plain versions on
       the calls of that gait update (``kernel_checks``); the whole loop
       replayed through the two graphs and timed; one control tick graphed
       and timed, and its device busy share under ``torch.profiler``,
       graphed and eager.
    3. Card against CPU: two scenarios of one RTI period from one plan, on
       the card in float32 and on the CPU in float64 (and float32).
    Returns (the launches of step 1, the kernel rows of step 2)."""
    import torch
    from bilevel_gait_gen_tpu_torch.models import rbd
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.sim import engine
    from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed, tree_map
    t_phase = time.perf_counter()
    cfg, wb, sim = loop_configs()
    B = LOOP_BATCH
    (model, params, st, q0, v0, x_des), start_ms = timed_ms(
        loop_start, cfg, sim, B, DEVICE, torch.float32)
    bounds0 = st.traj.sched.bounds.clone()
    n_periods = LOOP_TICKS // MPC_EVERY

    # 1. the entry point
    kernels.reset_launch_counts()
    (st_out, log), loop_ms = timed_ms(lambda: engine.closed_loop(
        model, params, cfg, wb, sim, st, q0, v0, x_des, n_ticks=LOOP_TICKS,
        control_dt=CONTROL_DT, mpc_every=MPC_EVERY, gait_opt_every=GAIT_EVERY,
        contact_sync=True))
    launches = kernels.launch_counts()
    for name in ("gtwg", "ipm_iter"):
        check(launches[name] > 0, f"{name} launched in the closed loop")
    check(tuple(log.q.shape) == (LOOP_TICKS, B, model.nq), "log shape")
    for name in ("q", "v", "srb_state", "tau"):
        check(bool(torch.isfinite(getattr(log, name)).all()),
              f"closed loop: every {name} finite")
    mpc_ticks = torch.arange(0, LOOP_TICKS, MPC_EVERY, device=log.q.device)
    check(bool(torch.isfinite(log.cost[mpc_ticks]).all()),
          "closed loop: the cost of every MPC update finite")
    z_min = log.q[..., 2].amin(dim=0)
    check(bool((z_min > 0.15).all()), f"base z above 0.15 m in every "
          f"scenario (lowest {float(z_min.min()):.4f} m)")
    solved = float(log.solved[mpc_ticks].float().mean())
    dlen = float(torch.amax(torch.abs(torch.diff(st_out.traj.sched.bounds)
                                      - torch.diff(bounds0))))

    # 2. each period graphed against its eager run
    ls0 = engine.initial_state(model, cfg, sim, st, q0, v0)

    def period_fn(gait):
        return lambda ls: engine.period(
            model, params, cfg, wb, sim, x_des, ls, control_dt=CONTROL_DT,
            ticks=MPC_EVERY, gait=gait, contact_sync=True)

    def carry(out):
        return out[0]

    eager_rti, eager_rti_ms = timed_ms(period_fn(False), ls0)
    g_rti, capture_rti_ms = timed_ms(lambda: Graphed(period_fn(False), ls0,
                                                     carry={0: carry}))
    n_out = check_bitwise(g_rti(ls0), eager_rti, "graphed RTI period")
    check(g_rti.captured_launches["gtwg"] == 0
          and g_rti.captured_launches["ipm_iter"] == 0,
          f"no kernel in the RTI period: {g_rti.captured_launches}")
    rti_ms = [timed_ms(g_rti)[1] for _ in range(GAIT_EVERY - 1)]
    ls_g = tree_map(torch.clone, g_rti.args[0])
    check(int(ls_g.tick) == GAIT_EVERY * MPC_EVERY, "replayed to the gait "
          "update's tick")
    feet = rbd.ee_positions(model, ls_g.q)
    t_g = (ls_g.tick.to(torch.float32) * CONTROL_DT).expand(B)
    calls = kc.record_kernel_calls(lambda: engine.mpc_update(
        model, params, cfg, ls_g, t_g, x_des, feet,
        engine.latch_contact(sim, feet, ls_g.mc), gait=True,
        contact_sync=True))
    krows = kc.check_recorded_calls(calls, "closed loop")
    eager_gait, eager_gait_ms = timed_ms(period_fn(True), ls_g)
    g_gait, capture_gait_ms = timed_ms(lambda: Graphed(
        period_fn(True), ls_g, carry={0: carry}))
    out, gait_ms = timed_ms(g_gait, ls_g)
    n_out += check_bitwise(out, eager_gait, "graphed gait period")
    for name in ("gtwg", "ipm_iter"):
        check(g_gait.captured_launches[name] > 0,
              f"{name} launched at the gait period's capture")
    # the whole loop again through the two graphs, timed
    cur, t0 = ls0, time.perf_counter()
    for i in range(n_periods):
        g = g_gait if engine.is_gait_period(i, GAIT_EVERY) else g_rti
        g(cur)
        cur = g.args[0]
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    check(torch.equal(cur.q, log.q[-1]), "the replayed loop ends where "
          "closed_loop ended, bit for bit")
    captured = {"rti": dict(g_rti.captured_launches),
                "gait": dict(g_gait.captured_launches)}
    # one control tick (after the gait update), graphed
    st_g = tree_map(torch.clone, g_gait.out[0].st)
    t1 = t_g + CONTROL_DT

    def tick(q, v, mc):
        return engine.control_tick(model, params, cfg, wb, sim, st_g, q, v,
                                   t1, t_g, mc, control_dt=CONTROL_DT)

    tick_args = (ls_g.q, ls_g.v, ls_g.mc)
    eager_tick_ms = [timed_ms(tick, *tick_args)[1] for _ in range(3)]
    g_tick = Graphed(tick, *tick_args)
    tick_ms = [timed_ms(g_tick)[1] for _ in range(10)]
    busy = {name: kc.profile_call(call, f"{name} control tick")
            for name, call in (("graphed", g_tick),
                               ("eager", lambda: tick(*tick_args)))}
    for g in (g_rti, g_gait, g_tick):
        g.close()

    # 3. card against CPU
    cmp = closed_loop_card_vs_cpu(cfg, wb, sim)
    sim_s = LOOP_TICKS * CONTROL_DT
    print(f"[closed-loop] {card}; batch {B}, {LOOP_TICKS} ticks "
          f"({n_periods} MPC periods of {MPC_EVERY}, the gait update in "
          f"periods {[i for i in range(n_periods) if engine.is_gait_period(i, GAIT_EVERY)]}): "
          f"start (settle, create_initial_run) {start_ms:.0f} ms; "
          f"closed_loop {loop_ms:.0f} ms with its two captures, launches "
          f"{launches}; replayed through the graphs {replay_s * 1e3:.0f} ms "
          f"= {LOOP_TICKS / replay_s:.1f} ticks/s, real-time factor "
          f"{B * sim_s / replay_s:.2f} (B x simulated s / wall s); solved "
          f"share of the MPC updates {solved:.4f}; phase lengths moved by "
          f"dlen {dlen:.3e} s; lowest base z {float(z_min.min()):.4f} m",
          flush=True)
    print(f"[closed-loop] RTI period: eager {eager_rti_ms:.0f} ms, capture "
          f"(2 warm-up calls included) {capture_rti_ms:.0f} ms, graphed "
          f"{', '.join(f'{t:.1f}' for t in rti_ms)} ms; gait period: eager "
          f"{eager_gait_ms:.0f} ms, capture {capture_gait_ms:.0f} ms, graphed "
          f"{gait_ms:.1f} ms; replay vs eager bit for bit on all {n_out} "
          f"outputs; captured launches {captured}; control tick: eager "
          f"{', '.join(f'{t:.2f}' for t in eager_tick_ms)} ms, graphed "
          f"median {float(np.median(tick_ms)):.3f} ms; device busy "
          + ", ".join(f"{k} {100 * r['busy_share_of_wall']:.1f}% of "
                      f"{r['wall_ms']:.2f} ms ({r['device_ops']} device "
                      f"operations)" for k, r in busy.items()), flush=True)
    print(f"[closed-loop] card vs CPU, 2 scenarios, one RTI period from one "
          f"plan: {cmp}", flush=True)
    print(f"[closed-loop] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, krows


def closed_loop_card_vs_cpu(cfg, wb, sim) -> str:
    """Two scenarios of the flagship start, planned once on the CPU in
    float64; one RTI period of the closed loop from there on the card in
    float32, on the CPU in float64 and in float32.  The first tick's
    torques and the period's base positions of the card are held to
    float64 within 10x the CPU float32 run's own distance (at least
    TOL_TAU, TOL_BASE)."""
    import torch
    from bilevel_gait_gen_tpu_torch.models import a1
    from bilevel_gait_gen_tpu_torch.sim import engine
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    _, params, st, q0, v0, x_des = loop_start(cfg, sim, 2, "cpu",
                                              torch.float64)
    runs = {}
    for key, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu32", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        def conv(a):
            return (a.to(device=dev, dtype=dtype) if a.is_floating_point()
                    else a.to(dev))
        model = a1.make_a1(device=dev)
        ls = engine.initial_state(model, cfg, sim, tree_map(conv, st),
                                  conv(q0), conv(v0))
        _, log = engine.period(model, tree_map(conv, params), cfg, wb, sim,
                               conv(x_des), ls, control_dt=CONTROL_DT,
                               ticks=MPC_EVERY, gait=False, contact_sync=True)
        runs[key] = (log.tau[0].double().cpu(), log.q[..., :3].double().cpu())
    parts = []
    for i, (name, floor) in enumerate((("first tick's torques", TOL_TAU),
                                       ("base positions", TOL_BASE))):
        ref = runs["cpu64"][i]
        d_card = float(torch.amax(torch.abs(runs["card"][i] - ref)))
        d32 = float(torch.amax(torch.abs(runs["cpu32"][i] - ref)))
        tol = max(10.0 * d32, floor)
        check(d_card <= tol, f"card vs CPU, {name}: {d_card:.3e} > "
              f"{tol:.3e}")
        parts.append(f"{name} max|card - cpu64| {d_card:.3e} (cpu32 "
                     f"{d32:.3e}; limit {tol:.3e})")
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# phase 9: the centroidal RTI
# ---------------------------------------------------------------------------

CENT_BATCH = 128
CENT_STEPS = 10         # RTIs at t = 0.05 k after the initial run
CENT_PERT = 0.01        # rad, the joints' perturbation per scenario
CHOL_GAP = 10.0         # chol_inverse: max|dSi| / max|Si| within 10x the plain
                        # version's own float32-vs-float64 gap on the same S
CHOL_RES = 2.0          # max|S Si - I| within 2x the plain version's own
TOL_DEFECT = 1e-3       # card vs CPU float64, the step's defect_l1 (or 10x
                        # the CPU float32 run's distance, if larger)
DEFECT_BAR = 1e-2       # tests/test_centroidal.py's defect_l1 bar, held by
                        # the CPU float64 run of the compared step


def centroidal_config():
    """tests/test_centroidal.py::test_centroidal_closed_loop_stand's
    configuration: N = 20, dt = 0.05, 18 sweeps a QP, the force carrier."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(ipm_iters=18, force_carrier=True).validate()


def centroidal_start(cfg, batch: int, device, dtype):
    """The acceptance test's start, batch first: A1 at the settled stand,
    the standing gait, x_des the start state; ``batch`` scenarios whose
    joints are moved by CENT_PERT * N(0, 1) from a seeded numpy generator.
    Returns (model, params, state, x0 [B, 13], feet [B, E, 3],
    x_des [B, 12])."""
    import torch
    from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
    from bilevel_gait_gen_tpu_torch.mpc import centroidal, gait
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
    from bilevel_gait_gen_tpu_torch.sim import engine
    _, _, sim = loop_configs()
    model = a1.make_a1(device=device)
    stand = torch.tensor(a1.stand_config(), dtype=dtype, device=device)
    q0 = engine.settled_stand(model, sim, stand)
    params = srb.make_srb_params(model, q0)
    dq = CENT_PERT * np.random.default_rng(1).standard_normal(
        (batch, model.num_joints))
    q0s = q0.expand(batch, -1) + torch.cat([
        torch.zeros(batch, 7, dtype=dtype, device=device),
        torch.tensor(dq, dtype=dtype, device=device)], dim=-1)
    x0 = srb.reconstruct_state(params, q0s, torch.zeros(
        batch, model.nv, dtype=dtype, device=device))
    feet = rbd.ee_positions(model, q0s)
    traj = default_trajectory(cfg, gait.make_standing(
        cfg, dtype=dtype, device=device), x0, feet[..., :2])
    box = torch.tensor([cfg.ee_box_size] * batch, dtype=dtype, device=device)
    st = centroidal.make_centroidal_state(cfg, model, traj, box, q0s)
    return model, params, st, x0, feet, srb.manifold_to_tangent(x0)


def straddling_nodes(cfg, sched, t0) -> list[int]:
    """Nodes whose forward difference (t, t + 1e-4) of the FK rows crosses
    a phase bound of ``sched`` advanced to ``t0`` (the node times as
    ``assemble_centroidal`` computes them, in the schedule's dtype)."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import gait
    sh = gait.advance_window(sched, t0, cfg)
    times = t0[:, None] + cfg.dt * torch.arange(
        cfg.num_nodes, dtype=t0.dtype, device=t0.device)
    b = sh.bounds[:, None]                             # [B, 1, E, P+1]
    tt = times[..., None]                              # [B, N, 1]
    cross = gait.phase_index(b, tt) != gait.phase_index(b, tt + 1e-4)
    return sorted(set(cross.any(-1).nonzero()[:, 1].tolist()))


def finite_outputs(*trees) -> bool:
    """Every tensor of ``trees`` finite, but for a warm start's ``gap``,
    whose inf is the solver's "not a solution" sentinel."""
    import torch
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves
    leaves = []
    for tree in trees:
        warm = getattr(tree, "qp_warm", None)
        if warm is not None:
            tree = dataclasses.replace(tree, qp_warm=dataclasses.replace(
                warm, gap=torch.zeros_like(warm.gap)))
        leaves += tree_leaves(tree)
    return all(bool(torch.isfinite(t).all()) for t in leaves
               if t.is_floating_point())


def check_schur_stage(args, kw, label: str = "centroidal") -> list[dict]:
    """The Schur stage of a recorded p > 32 ``ipm_iter`` call on its own
    operands (A, the sweep's Mi): ``rgemm`` for A Mi and (A Mi) A^T against
    the plain products, ``chol_inverse`` against the plain unrolled
    Cholesky; each timed beside its plain version, its bound and the one
    PyTorch call that computes the same function (``bmm``, ``baddbmm``,
    ``linalg.inv_ex``).  Then the iteration kernel that follows the stage,
    ``ipm_iter_handed_kernel``, launched alone on the stage's own A Mi and
    S^-1: its result bit for bit the wrapper's sweep (which
    ``kernel_checks.check_recorded_calls`` holds to the plain version), its
    time beside the sweep's through the wrapper, its bytes bound and the
    bytes its passes move.  Returns one row per kernel."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    A, Mi = args[2].contiguous(), args[14].contiguous()
    reg_s = max(kw["reg"], 1e-7)
    B, p, n = A.shape
    At = A.mT.contiguous()
    AMi = kernels.rgemm(A, Mi)
    S = kernels.rgemm(AMi, At, diag=reg_s)
    Si = kernels.chol_inverse(S)
    ref_ami = kernels.rgemm_reference(A, Mi)
    ref_s = kernels.rgemm_reference(AMi, At, reg_s)
    ref_si = kernels.chol_inverse_unrolled(S)
    ref_si64 = kernels.chol_inverse_unrolled(S.double())
    torch.cuda.synchronize()
    e_ami, e_s = kc.rel_err(AMi, ref_ami), kc.rel_err(S, ref_s)
    e_si = kc.rel_err(Si, ref_si)
    e64 = kc.rel_err(ref_si, ref_si64.float())
    tol_si = CHOL_GAP * e64
    # the residual in float64 weighs every entry, the small ones too
    eye64 = torch.eye(p, dtype=torch.float64, device=A.device)
    res = float(torch.amax(torch.abs(S.double() @ Si.double() - eye64)))
    res_ref = float(torch.amax(torch.abs(S.double() @ ref_si.double()
                                         - eye64)))
    si_abs = torch.abs(Si).flatten()
    si_nz = float((si_abs > 0).float().mean())
    si_med = float(torch.median(si_abs[si_abs > 0]))
    check(e_ami <= kc.TOL_GTWG, f"rgemm A Mi rel {e_ami:.3e}")
    check(e_s <= kc.TOL_GTWG, f"rgemm (A Mi) A^T rel {e_s:.3e}")
    check(e_si <= tol_si, f"chol_inverse rel {e_si:.3e} > {tol_si:.3e}")
    check(res <= CHOL_RES * res_ref, f"chol_inverse: max|S Si - I| {res:.3e} "
          f"> {CHOL_RES} x the plain version's {res_ref:.3e}")
    check(torch.equal(Si, Si.mT), "chol_inverse: S^-1 exactly symmetric")
    eye = torch.eye(p, device=A.device).expand(B, p, p)
    t_ami = kc.cuda_ms(lambda: kernels.rgemm(A, Mi))
    t_s = kc.cuda_ms(lambda: kernels.rgemm(AMi, At, diag=reg_s))
    rows = [dict(name="rgemm", route="cuda",
                 source="bilevel_gait_gen_tpu_torch/csrc/gtwg.cu",
                 replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:155",
                 max_abs_err=max(float(torch.amax(torch.abs(AMi - ref_ami))),
                                 float(torch.amax(torch.abs(S - ref_s)))),
                 max_rel_err=max(e_ami, e_s), tol=kc.TOL_GTWG,
                 ms=t_ami + t_s,
                 plain_ms=kc.cuda_ms(lambda: kernels.rgemm_reference(
                     kernels.rgemm_reference(A, Mi), At, reg_s)),
                 bound_ms=None, bound_by=None,
                 library_ms=kc.cuda_ms(lambda: torch.baddbmm(
                     eye, torch.bmm(A, Mi), At, beta=reg_s)),
                 shape=[B, p, n], a_mi_ms=t_ami, s_ms=t_s,
                 a_mi_library_ms=kc.cuda_ms(lambda: torch.bmm(A, Mi)),
                 s_library_ms=kc.cuda_ms(lambda: torch.baddbmm(
                     eye, AMi, At, beta=reg_s)))]
    b_ami = kc.bound_ms(2.0 * B * p * n * n, 4.0 * B * (2 * p * n + n * n))
    b_s = kc.bound_ms(2.0 * B * p * p * n, 4.0 * B * (2 * p * n + p * p))
    rows[0]["bound_ms"] = b_ami[0] + b_s[0]
    rows[0]["bound_by"] = b_ami[1]      # the larger of the two products
    rows[0]["a_mi_bound_ms"], rows[0]["s_bound_ms"] = b_ami[0], b_s[0]
    bnd, by = kc.bound_ms(1.0 * B * p ** 3, 4.0 * B * 2 * p * p)
    rows.append(dict(name="chol_inverse", route="cuda",
                     source="bilevel_gait_gen_tpu_torch/csrc/chol_inverse.cu",
                     replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:119",
                     max_abs_err=float(torch.amax(torch.abs(Si - ref_si))),
                     max_rel_err=e_si, tol=tol_si, f32_vs_f64=e64,
                     residual=res, plain_residual=res_ref,
                     max_abs_si=float(si_abs.max()),
                     median_nonzero_abs_si=si_med, nonzero_share_si=si_nz,
                     ms=kc.cuda_ms(lambda: kernels.chol_inverse(S)),
                     plain_ms=kc.cuda_ms(
                         lambda: kernels.chol_inverse_unrolled(S), reps=3),
                     bound_ms=bnd, bound_by=by,
                     library_ms=kc.cuda_ms(
                         lambda: torch.linalg.inv_ex(S).inverse),
                     shape=[B, p]))
    rows.append(check_handed_kernel(args, kw, A, Mi, AMi, Si))
    r0, r1, r2 = rows
    print(f"[{label}] Schur stage [{B}, p={p}, n={n}]: rgemm A Mi rel "
          f"{e_ami:.2e}, (A Mi) A^T rel {e_s:.2e} (<= {kc.TOL_GTWG}); "
          f"kernel {r0['a_mi_ms']:.3f} + {r0['s_ms']:.3f} ms (bmm "
          f"{r0['a_mi_library_ms']:.3f}, baddbmm {r0['s_library_ms']:.3f}; "
          f"bound {r0['a_mi_bound_ms']:.3f} + {r0['s_bound_ms']:.3f} ms); "
          f"chol_inverse rel {e_si:.2e} (<= {tol_si:.2e}, {CHOL_GAP:g}x the "
          f"plain float32 vs float64 {e64:.2e}; max|Si| "
          f"{r1['max_abs_si']:.3e}, median of the nonzero {si_med:.3e}, "
          f"nonzero share {si_nz:.3f}), max|S Si - I| {res:.3e} (plain "
          f"{res_ref:.3e}, <= {CHOL_RES:g}x), kernel {r1['ms']:.3f} ms, plain "
          f"{r1['plain_ms']:.3f} ms, inv_ex {r1['library_ms']:.3f} ms, "
          f"bound {bnd:.3f} ms ({by})", flush=True)
    print(f"[{label}] ipm_iter_handed_kernel alone [{B}, {r2['shape'][1]}, "
          f"{r2['shape'][2]}, {p}] on the stage's A Mi and S^-1: bit for bit "
          f"the wrapper's sweep; rel to the plain sweep {r2['max_rel_err']:.2e} "
          f"(the wrapper's sweep is gated above); kernel {r2['ms']:.3f} ms, "
          f"the sweep through the wrapper {r2['sweep_ms']:.3f} ms, plain sweep "
          f"{r2['plain_ms']:.3f} ms; bound {r2['bound_ms']:.3f} ms "
          f"({r2['bound_by']}: {r2['bound_bytes'] / 1e9:.3f} GB, its inputs "
          f"once); its passes move {r2['design_bytes'] / 1e9:.3f} GB "
          f"({r2['design_bytes_ms']:.3f} ms at the memory rate; the first "
          f"version's {r2['first_version_bytes'] / 1e9:.3f} GB), "
          f"{r2['design_bytes'] / r2['ms'] / 1e9:.3f} TB/s achieved",
          flush=True)
    return rows


def check_handed_kernel(args, kw, A, Mi, AMi, Si) -> dict:
    """``ipm_iter_handed_kernel`` launched alone (``ipm_iter_launch`` with the
    stage's ``AMi`` and ``Si``) on a recorded p > 32 sweep: bit for bit the
    sweep through the wrapper on the same state, timed in place (launches
    in a row, the state stepping on), its bound by
    ``kernel_checks.handed_sweep_bytes``.  Returns the kernel's row."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    check(not args[15], "the recorded p > 32 sweep is an exact sweep")
    lib, _ = kernels.build()
    H, q, _, b, G, h, ga = (t.contiguous() for t in args[:7])
    B, m, n = G.shape
    p = A.shape[-2]
    M = kw.get("M")
    if M is None:
        M = kernels.gtwg(H, G, lam=args[9], s=args[10],
                         w_hi=0.01 / torch.finfo(torch.float32).eps,
                         reg=kw["reg"])
    M = M.contiguous()
    step = dict(reg=kw["reg"], tol=kw["tol"], refine_steps=kw["refine_steps"],
                Si=Si, AMi=AMi)

    def state():
        st = kc.fresh_state(args)
        return [t.contiguous() for t in (*st[7:11], *st[13])] + [
            st[11].to(torch.int32), st[12].contiguous()]

    st = state()
    kernels.ipm_iter_launch(lib, kernels._stream(), H, q, A, b, G, h, ga, M,
                            Mi, *st, **step)
    wrapped = kernels.ipm_iter(*kc.fresh_state(args), **kw)
    ref = kernels.ipm_iter_reference(*kc.clone_args(args), **kw)
    torch.cuda.synchronize()
    for name, a, w in zip(("x", "y", "lam", "s"), st[:4], wrapped[:4]):
        check(torch.equal(a, w), f"ipm_iter_handed_kernel alone: {name} bit "
              f"for bit the wrapper's sweep")
    check(torch.equal(st[9].bool(), wrapped[4]) and torch.equal(st[10],
                                                                wrapped[5]),
          "ipm_iter_handed_kernel alone: done and it the wrapper's")
    st = state()
    ms = kc.cuda_ms(lambda: kernels.ipm_iter_launch(
        lib, kernels._stream(), H, q, A, b, G, h, ga, M, Mi, *st, **step),
        inner=3)
    nbytes = kc.handed_sweep_bytes(B, m, n, p, kw["refine_steps"])
    # two operations for each matrix entry a pass reads
    bnd, by = kc.bound_ms(0.5 * nbytes["design"], nbytes["bound"])
    return dict(
        name="ipm_iter_handed_kernel", route="cuda",
        source="bilevel_gait_gen_tpu_torch/csrc/ipm_iter.cu",
        replaces="bilevel_gait_gen_tpu/ops/pallas_kernels.py:155",
        max_abs_err=max(float(torch.amax(torch.abs(a - r)))
                        for a, r in zip(wrapped[:4], ref[:4])),
        max_rel_err=max(kc.rel_err(a, r) for a, r in zip(wrapped[:4],
                                                         ref[:4])),
        ms=ms, sweep_ms=kc.cuda_ms(lambda: kernels.ipm_iter(
            *kc.fresh_state(args), **kw)),
        plain_ms=kc.cuda_ms(lambda: kernels.ipm_iter_reference(
            *kc.fresh_state(args), **kw), reps=3),
        plain_covers="the whole sweep (ipm_iter_reference)",
        bound_ms=bnd, bound_by=by, library_ms=None,
        bound_bytes=nbytes["bound"], design_bytes=nbytes["design"],
        first_version_bytes=nbytes["first_version"],
        design_bytes_ms=kc.bound_ms(0.0, nbytes["design"])[0],
        shape=[B, n, m, p])


def phase_centroidal(card: str):
    """Phase 9: the centroidal RTI (``mpc/centroidal.py``) at batch 128,
    N = 20, float32 on the card: the QP is [n=472, p=256, m=1712], padded
    to [512, 256, 1792] for the fused sweep.

    1. The entry points, with the kernels' counts set to 0 before and read
       after: ``create_initial_run_centroidal`` and CENT_STEPS
       ``solve_centroidal_step``s at t = 0.05 k with the window shifting.
       Every sweep is exact: one ``gtwg``, one ``ipm_iter`` (its iteration
       kernel ``ipm_iter_handed_kernel``), two ``rgemm`` and one
       ``chol_inverse`` launch a sweep, counted.  Every output
       finite; the initial run solved in every scenario; every step before
       the first whose FK rows straddle a phase bound (below) solved in
       every scenario with alpha >= 0.5 and the joint velocities within
       their limit (the JAX package's acceptance bar,
       tests/test_centroidal.py; its defect_l1 < 1e-2 belongs to that
       test's float64: in float32 the defect is ~30x larger, on the CPU as
       on the card, so it is printed here and held in 4. to the CPU runs of
       one step, the float64 one to the bar).  A fault of the
       reference, reproduced: the FK rows' foot velocity is a forward
       difference over (t, t + 1e-4), and in float32 the node time
       t0 + 15 dt at t0 = 0.15 rounds one ulp below the standing gait's
       chained-stance bound 0.9, so the difference jumps between two
       stance slots' footholds and the QP loses its feasible point
       (tests/test_torch_centroidal.py pins it against the JAX package);
       the steps from there on are printed, not gated.
    2. The kernels on the calls of step 1 (gated and solved) recorded by
       ``kernel_checks``: ``gtwg`` at [128, 512, 1792], the sweep at
       p = 256, the Schur stage on its own operands; each held to its
       plain version and timed.
    3. Step 1 captured as a CUDA graph, its replay held to the eager step
       bit for bit; eager and graphed ms.
    4. Card against CPU: two scenarios planned once on the CPU in float64,
       one step from there on the card (float32), on the CPU in float64
       and float32; positions, cost and defect_l1 held to float64.
    Returns (the launches of step 1, the kernel rows of step 2)."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import centroidal
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
    t_phase = time.perf_counter()
    cfg = centroidal_config()
    B = CENT_BATCH
    model, params, st, x0, feet, x_des = centroidal_start(
        cfg, B, DEVICE, torch.float32)

    def step(s, t0):
        return centroidal.solve_centroidal_step(cfg, model, params, s, x0, t0,
                                                feet, x_des)

    # 1. the entry points
    kernels.reset_launch_counts()
    (st, stats0), init_ms = timed_ms(
        centroidal.create_initial_run_centroidal, cfg, model, params, st, x0,
        feet, x_des)
    check(bool(stats0.solved.all()), "the centroidal initial run solved in "
          "every scenario")
    st_init = st
    step_ms, per_step, gated = [], [], True
    for k in range(1, CENT_STEPS + 1):
        t0 = torch.full((B,), 0.05 * k, device=x0.device)
        cross = straddling_nodes(cfg, st.traj.sched, t0)
        gated = gated and not cross
        (st, stats), ms = timed_ms(step, st, t0)
        step_ms.append(ms)
        check(finite_outputs(st, stats),
              f"centroidal step {k}: every output finite")
        row = dict(step=k, straddling_nodes=cross, gated=gated,
                   solved=float(stats.solved.float().mean()),
                   alpha_min=float(stats.alpha.min()),
                   defect_max=float(stats.defect_l1.max()),
                   vj_max=float(st.vj.abs().max()))
        per_step.append(row)
        if gated:
            check(row["solved"] == 1.0 and row["alpha_min"] >= 0.5
                  and row["vj_max"] <= float(model.velocity_limit[0]),
                  f"centroidal step {k}: the acceptance bar {row}")
    check(per_step[0]["gated"], "the first centroidal step is gated")
    launches = kernels.launch_counts()
    by_kernel = dict(kernels.ipm_iter.launches_by_kernel)
    sweeps = (cfg.init_run_iters + CENT_STEPS) * cfg.ipm_iters
    want = {"gtwg": sweeps, "ipm_iter": sweeps, "gj_inverse": 0,
            "rgemm": 2 * sweeps, "chol_inverse": sweeps}
    check(launches == want, f"centroidal launches {launches}, not {want}")
    check(by_kernel == {"ipm_iter_kernel": 0,
                        "ipm_iter_handed_kernel": sweeps},
          f"centroidal iteration kernels {by_kernel}: every sweep handed")
    launches["ipm_iter_handed_kernel"] = sweeps
    check(tuple(st.vj.shape) == (B, cfg.num_nodes, model.num_joints),
          "joint velocities' shape")

    # 2. the kernels on the calls of step 1, from the initial run's plan
    t_1 = torch.full((B,), 0.05, device=x0.device)
    calls = kc.record_kernel_calls(lambda: step(st_init, t_1))
    krows = kc.check_recorded_calls(calls, "centroidal")
    key = next(k for k in calls if k[0] == "ipm_iter")
    schur_rows = check_schur_stage(*calls[key])

    # 3. step 1 as a CUDA graph
    eager, eager_ms = timed_ms(step, st_init, t_1)
    g, capture_ms = timed_ms(lambda: Graphed(step, st_init, t_1))
    n_out = check_bitwise(g(), eager, "graphed centroidal step")
    graph_ms = [timed_ms(g)[1] for _ in range(3)]
    captured = dict(g.captured_launches)
    g.close()

    # 4. card against CPU
    cmp = centroidal_card_vs_cpu(cfg)
    print(f"[centroidal] {card}; batch {B}, N={cfg.num_nodes}, QP [n=472, "
          f"p=256, m=1712] padded to [512, 256, 1792]: create_initial_run "
          f"({cfg.init_run_iters} SQP iterations) {init_ms:.0f} ms, solved "
          f"{float(stats0.solved.float().mean()):.4f}, then {CENT_STEPS} "
          f"steps, ms {', '.join(f'{t:.0f}' for t in step_ms)}; launches "
          f"{launches}; per step (gated until the first straddle): "
          + "; ".join(f"{r['step']}{'' if r['gated'] else '*'}: solved "
                      f"{r['solved']:.3f}, alpha >= {r['alpha_min']:.3f}, "
                      f"defect_l1 <= {r['defect_max']:.2e}, max|v_j| "
                      f"{r['vj_max']:.3g}"
                      + (f", nodes {r['straddling_nodes']} straddle"
                         if r["straddling_nodes"] else "")
                      for r in per_step), flush=True)
    print(f"[centroidal] step 1: eager {eager_ms:.1f} ms, capture (2 "
          f"warm-up calls included) {capture_ms:.0f} ms, graphed "
          f"{', '.join(f'{t:.1f}' for t in graph_ms)} ms; replay vs eager "
          f"bit for bit on all {n_out} outputs; captured launches "
          f"{captured}", flush=True)
    print(f"[centroidal] card vs CPU, 2 scenarios, one step from one plan: "
          f"{cmp}", flush=True)
    print(f"[centroidal] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, krows, schur_rows, dict(
        eager_step_ms=eager_ms, graphed_step_ms=float(np.median(graph_ms)),
        steps_ms=step_ms, init_ms=init_ms, per_step=per_step)


def centroidal_card_vs_cpu(cfg) -> str:
    """Two scenarios of phase 9's start, planned once on the CPU in float64
    (create_initial_run_centroidal), then one step at t = 0.05 from that
    plan on the card in float32, on the CPU in float64 and in float32.  The
    planned COM positions are held to float64 within 10x the CPU float32
    run's own distance (at least TOL_BASE), the step's cost to 10x its
    relative distance (at least TOL_OBJ), the step's defect_l1 to 10x its
    distance (at least TOL_DEFECT); every scenario solved on the card, and
    the float64 run within the JAX package's acceptance bar DEFECT_BAR (in
    float32 the defect is ~30x the float64 one, on the CPU as on the card,
    so phase 9's steps are not held to that bar)."""
    import torch
    from bilevel_gait_gen_tpu_torch.models import a1
    from bilevel_gait_gen_tpu_torch.mpc import centroidal
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    _, params, st, x0, feet, x_des = centroidal_start(cfg, 2, "cpu",
                                                      torch.float64)
    model64 = a1.make_a1(device="cpu")
    st, _ = centroidal.create_initial_run_centroidal(cfg, model64, params, st,
                                                     x0, feet, x_des)
    runs = {}
    for key, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu32", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        def conv(a):
            return (a.to(device=dev, dtype=dtype) if a.is_floating_point()
                    else a.to(dev))
        st2, stats = centroidal.solve_centroidal_step(
            cfg, a1.make_a1(device=dev), tree_map(conv, params),
            tree_map(conv, st), conv(x0), torch.full((2,), 0.05, device=dev,
                                                     dtype=dtype),
            conv(feet), conv(x_des))
        if key == "card":
            check(bool(stats.solved.all()), "card vs CPU: the card's step "
                  "solved")
        runs[key] = (st2.traj.x_man[..., :3].double().cpu(),
                     stats.cost.double().cpu(),
                     stats.defect_l1.double().cpu())
    pos64, cost64, def64 = runs["cpu64"]
    d_card = float(torch.amax(torch.abs(runs["card"][0] - pos64)))
    d32 = float(torch.amax(torch.abs(runs["cpu32"][0] - pos64)))
    tol = max(10.0 * d32, TOL_BASE)
    check(d_card <= tol, f"card vs CPU, planned positions: {d_card:.3e} > "
          f"{tol:.3e}")
    rel = float(torch.amax(torch.abs(runs["card"][1] - cost64)
                           / torch.clamp_min(cost64.abs(), 1.0)))
    rel32 = float(torch.amax(torch.abs(runs["cpu32"][1] - cost64)
                             / torch.clamp_min(cost64.abs(), 1.0)))
    tol_c = max(10.0 * rel32, TOL_OBJ)
    check(rel <= tol_c, f"card vs CPU, step cost rel {rel:.3e} > "
          f"{tol_c:.3e}")
    e_def = float(torch.amax(torch.abs(runs["card"][2] - def64)))
    e_def32 = float(torch.amax(torch.abs(runs["cpu32"][2] - def64)))
    tol_d = max(10.0 * e_def32, TOL_DEFECT)
    check(e_def <= tol_d, f"card vs CPU, step defect_l1 {e_def:.3e} > "
          f"{tol_d:.3e}")
    check(float(def64.max()) < DEFECT_BAR, f"CPU float64 step defect_l1 "
          f"{def64.tolist()}, not < {DEFECT_BAR}")
    return (f"planned positions max|card - cpu64| {d_card:.3e} m (cpu32 "
            f"{d32:.3e}; limit {tol:.3e}); step cost rel {rel:.3e} (cpu32 "
            f"{rel32:.3e}; limit {tol_c:.3e}); costs card "
            f"{runs['card'][1].tolist()} cpu64 {cost64.tolist()}; defect_l1 "
            f"card {runs['card'][2].tolist()} cpu32 "
            f"{runs['cpu32'][2].tolist()} cpu64 {def64.tolist()} (< "
            f"{DEFECT_BAR}), max|card - cpu64| {e_def:.3e} (cpu32 "
            f"{e_def32:.3e}; limit {tol_d:.3e})")


# ---------------------------------------------------------------------------
# phase 10: the ADMM backend
# ---------------------------------------------------------------------------

ADMM_ITERS = 1600       # tests/test_admm.py's RTI on the ADMM backend
ADMM_BLOCK = 3          # RTIs in phase 10's block (the bench's has 9: ~55
                        # launches an ADMM iteration, ~800,000 a block)
TOL_ADMM_POS = 1e-6     # m, card against CPU, both float64
TOL_ADMM_COST = 1e-6    # relative, the same


def phase_admm(cfg):
    """Phase 10: ``solve_step`` with ``qp_backend="admm"`` on the bench
    problem (batch 128, N = 20, the trot), ADMM_ITERS iterations a QP, in
    float64: in float32 the ADMM backend is non-finite on the MPC QP, in
    the JAX package as in the port (the Ruiz equilibration scales a masked,
    all-zero equality row by 1e4 a sweep, 1e40 after ten, past float32's
    range, and u d_c = 0 inf = NaN); one float32 RTI shows it, printed.
    One RTI block (``cadence.rti_block``, ADMM_BLOCK RTIs) eagerly with the
    kernels' counts set to 0 (no hand-written kernel on this path) and as a
    CUDA graph replay, held to the eager block bit for bit; every output
    finite; the solved share, qp_pri and the ADMM iterations printed beside
    the ms a block, and the interior-point block's ms (float32, graphed) in
    the same run.  Then two scenarios of one RTI on the card against the
    CPU, both in float64, within TOL_ADMM_POS and TOL_ADMM_COST."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import cadence, solver
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
    t_phase = time.perf_counter()
    acfg = dataclasses.replace(cfg, qp_backend="admm", admm_iters=ADMM_ITERS)
    pr = make_problem(acfg, BATCH, device=DEVICE, dtype=torch.float64)

    def block(c, prob):
        return lambda st, *rest: cadence.rti_block(c, prob.params, st, *rest,
                                                   ADMM_BLOCK)

    kernels.reset_launch_counts()
    eager, eager_ms = timed_ms(block(acfg, pr), *pr.loop_args())
    launches = kernels.launch_counts()
    check(not any(launches.values()), f"no kernel on the ADMM path: "
          f"{launches}")
    st, _, solved = eager
    check(finite_outputs(*eager), "ADMM block: every output finite")
    g, capture_ms = timed_ms(lambda: Graphed(block(acfg, pr),
                                             *pr.loop_args()))
    n_out = check_bitwise(g(), eager, "graphed ADMM block")
    graph_ms = [timed_ms(g)[1] for _ in range(2)]
    g.close()
    pr32 = make_problem(cfg, BATCH, device=DEVICE, dtype=torch.float32)
    gp = Graphed(block(cfg, pr32), *pr32.loop_args())
    pdip_ms = [timed_ms(gp)[1] for _ in range(2)]
    gp.close()
    one = solver.solve_step(acfg, pr.params, st, *pr.loop_args()[1:])[1]
    iters = st.qp_warm.iters.float()
    pr_f32 = make_problem(acfg, BATCH, device=DEVICE, dtype=torch.float32)
    st32, stats32 = solver.solve_step(acfg, pr_f32.params,
                                      *pr_f32.loop_args())
    nonfinite32 = int((~torch.isfinite(st32.qp_warm.x).all(-1)).sum())
    cmp = admm_card_vs_cpu(acfg)
    print(f"[admm] batch {BATCH}, N={cfg.num_nodes}, float64, {ADMM_ITERS} "
          f"ADMM iterations a QP, a block of {ADMM_BLOCK} RTIs: eager "
          f"{eager_ms:.0f} ms, capture (2 warm-up calls included) "
          f"{capture_ms:.0f} ms, graphed "
          f"{', '.join(f'{t:.0f}' for t in graph_ms)} ms (the "
          f"interior-point block, float32, graphed: "
          f"{', '.join(f'{t:.0f}' for t in pdip_ms)} ms); replay vs eager "
          f"bit for bit on all {n_out} outputs; solved share "
          f"{float(solved.float().mean()):.4f} (last RTI "
          f"{float(solved[-1].float().mean()):.4f}); the next RTI's qp_pri "
          f"median {float(one.qp_pri.median()):.3e}, max "
          f"{float(one.qp_pri.max()):.3e}; ADMM iterations of the last QP "
          f"mean {float(iters.mean()):.0f}, min {float(iters.min()):.0f}, "
          f"max {float(iters.max()):.0f}; launches {launches}; in float32 "
          f"one RTI's solution is non-finite in {nonfinite32} of {BATCH} "
          f"scenarios (solved {float(stats32.solved.float().mean()):.4f}), "
          f"as in the JAX package", flush=True)
    print(f"[admm] card vs CPU, float64, 2 scenarios, one RTI: {cmp}",
          flush=True)
    print(f"[admm] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(eager_block_ms=eager_ms,
                graphed_block_ms=float(np.median(graph_ms)),
                pdip_graphed_block_ms=float(np.median(pdip_ms)),
                float32_nonfinite=nonfinite32)


def admm_card_vs_cpu(acfg) -> str:
    """Two scenarios of one RTI on the ADMM backend, float64 on the card
    and on the CPU (the float32 runs are non-finite, see phase_admm): the
    planned positions within TOL_ADMM_POS, the cost within TOL_ADMM_COST."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import solver
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    runs = {}
    for key, dev in (("card", DEVICE), ("cpu64", "cpu")):
        pr = make_problem(acfg, 2, device=dev, dtype=torch.float64)
        st, stats = solver.solve_step(acfg, pr.params, *pr.loop_args())
        check(bool(stats.solved.all()), f"ADMM RTI on {key}: solved")
        runs[key] = (st.traj.x_man[..., :3].cpu(), stats.cost.cpu())
    d = float(torch.amax(torch.abs(runs["card"][0] - runs["cpu64"][0])))
    rel = float(torch.amax(torch.abs(runs["card"][1] - runs["cpu64"][1])
                           / torch.clamp_min(runs["cpu64"][1].abs(), 1.0)))
    check(d <= TOL_ADMM_POS, f"ADMM card vs CPU, planned positions {d:.3e}")
    check(rel <= TOL_ADMM_COST, f"ADMM card vs CPU, cost rel {rel:.3e}")
    return (f"planned positions max|card - cpu| {d:.3e} m (limit "
            f"{TOL_ADMM_POS}); cost rel {rel:.3e} (limit {TOL_ADMM_COST}); "
            f"costs card {runs['card'][1].tolist()}")


# ---------------------------------------------------------------------------
# phase 11: the other robot families
# ---------------------------------------------------------------------------

FAMILIES = ("adam", "mini_cheetah")
FAMILY_BATCH = 128
FAMILY_REPLAYS = 3      # graphed cycles timed a family (cut these first if
                        # the script must shrink)
FAMILY_SOLVED = 0.95    # bench.py's gate on solved_frac
ADAM_YAML = "bilevel_gait_gen_tpu_torch/configs/adam_march.yaml"


def family_config(family: str):
    """Adam: configs/adam_march.yaml as it stands (N = 20, two point feet,
    Raibert capture stepping, double support, the force carrier, force
    bound 250 N); the Mini Cheetah: bench.py's configuration."""
    from bilevel_gait_gen_tpu_torch.utils.config import load_yaml
    if family == "adam":
        return load_yaml(str(REPO / ADAM_YAML))
    return bench_config()


def family_problem(family: str, cfg, batch: int, device, dtype, seed=0):
    """tests/test_models_multi.py:43-75's start for ``family`` ("adam" or
    "mini_cheetah"), batch first: the model at its stand, the trot, x_des
    the stand itself, the warm start the solver's sentinel; each
    scenario's measured state moved as bench.py's make_problem moves the
    A1's (``problem.perturbations``: 0.02 N(0, 1) from ``seed``, none on
    the quaternion).  Returns a ``problem.Problem``."""
    import torch
    from bilevel_gait_gen_tpu_torch.models import adam, mini_cheetah, rbd, srb
    from bilevel_gait_gen_tpu_torch.mpc import gait, solver
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
    from bilevel_gait_gen_tpu_torch.problem import Problem, perturbations
    if family == "adam":
        model, stand = adam.make_adam(device=device), adam.stand_config()
    else:
        model = mini_cheetah.make_mini_cheetah(device=device)
        stand = mini_cheetah.stand_config()
    q0 = torch.tensor(stand, device=device).to(dtype)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0, torch.zeros(
        model.nv, dtype=dtype, device=device))
    x0s = x0.expand(batch, -1)
    feets = rbd.ee_positions(model, q0).expand(batch, -1, -1).contiguous()
    traj = default_trajectory(cfg, gait.make_trot(cfg, dtype=dtype,
                                                  device=device),
                              x0s, feets[..., :2])
    box = torch.tensor(cfg.ee_box_size, dtype=dtype,
                       device=device).expand(batch, 2).contiguous()
    pert = torch.tensor(perturbations(batch, seed), device=device).to(dtype)
    return Problem(params=params, states=solver.make_state(cfg, traj, box),
                   x0s=x0s + pert,
                   t0=torch.zeros(batch, dtype=dtype, device=device),
                   feets=feets, x_des=srb.manifold_to_tangent(x0).expand(
                       batch, -1).contiguous())


def family_run(cfg, pr):
    """The cold start (``solver.create_initial_run``), then one cadence
    cycle from its plan: (initial state, its stats, the cycle's results)."""
    from bilevel_gait_gen_tpu_torch.mpc import cadence, solver
    st, stats = solver.create_initial_run(cfg, pr.params, pr.states, pr.x0s,
                                          pr.feets, pr.x_des, pr.t0)
    return st, stats, cadence.cycle(cfg, pr.params, st,
                                    *pr.loop_args()[1:], FREQ)


def phase_families(card: str):
    """Phase 11: the Adam biped (its shipped configs/adam_march.yaml) and
    the Mini Cheetah (bench.py's configuration), batch first at
    FAMILY_BATCH, float32 on the card.  Adam's QP is [n=116, p=28, m=616],
    its gait update's lanes [512, 128, 640, p=28] after padding: the fused
    chain at a p just under the resident limit of 32 and at half a column
    block; the Mini Cheetah has the A1's shapes and its own masses.  For
    each family:

    1. ``solver.create_initial_run`` with the kernels' counts set to 0
       before and read after; every output finite, solved_frac >= 0.95.
    2. One ``cadence.cycle`` (FREQ - 1 RTIs, then the gait update) eagerly,
       counts set to 0 before and read after: ``gtwg`` and ``ipm_iter``
       launched, ``rgemm`` and ``chol_inverse`` not (p <= 32 stays
       resident), ``gj_inverse`` not; every output finite, the cycle's
       solved_frac >= 0.95.
    3. The same cycle captured by ``Graphed``, its replay held to the eager
       cycle bit for bit, FAMILY_REPLAYS replays timed; the captured
       launches equal the eager counts.
    4. Adam only: the kernels on the cycle's own calls (``kernel_checks``):
       ``gtwg`` at [512, 128, 640] and the Newton-Schulz product at
       [512, 128, 128] (with ``baddbmm``), the sweep with its Newton-Schulz
       refresh and the exact sweep handed M at [512, 128, 640, p=28], each
       held to its plain version, timed and set beside its bound.
    5. Card against CPU (:func:`family_card_vs_cpu`).
    Returns (launches a cycle by family, the kernel rows of 4, ms)."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import cadence, solver
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
    t_phase = time.perf_counter()
    B = FAMILY_BATCH
    launches, krows, times = {}, [], {}
    for family in FAMILIES:
        cfg = family_config(family)
        pr = family_problem(family, cfg, B, DEVICE, torch.float32)

        # 1. the cold start
        kernels.reset_launch_counts()
        (st, stats), init_ms = timed_ms(
            solver.create_initial_run, cfg, pr.params, pr.states, pr.x0s,
            pr.feets, pr.x_des, pr.t0)
        init_launches = kernels.launch_counts()
        init_frac = float(stats.solved.float().mean())
        check(finite_outputs(st, stats), f"{family}: the cold start's "
              f"outputs finite")
        check(init_frac >= FAMILY_SOLVED, f"{family}: the cold start's "
              f"solved_frac {init_frac:.4f} >= {FAMILY_SOLVED}")

        # 2. one cycle eagerly
        def cycle(s, *rest):
            return cadence.cycle(cfg, pr.params, s, *rest, FREQ)

        args = (st, *pr.loop_args()[1:])
        kernels.reset_launch_counts()
        eager, eager_ms = timed_ms(cycle, *args)
        counts = kernels.launch_counts()
        st2, solved, gres, frac = eager
        check(finite_outputs(st2, gres.rti_stats) and all_finite(st2, [gres]),
              f"{family}: the cycle's outputs finite")
        check(float(frac) >= FAMILY_SOLVED, f"{family}: the cycle's "
              f"solved_frac {float(frac):.4f} >= {FAMILY_SOLVED}")
        check(counts["gtwg"] > 0 and counts["ipm_iter"] > 0,
              f"{family}: the fused kernels launched in the cycle {counts}")
        check(counts["rgemm"] == counts["chol_inverse"]
              == counts["gj_inverse"] == 0,
              f"{family}: p <= 32 stays resident, no Schur stage and no "
              f"Gauss-Jordan inverse {counts}")
        launches[family] = counts

        # 3. the cycle as a CUDA graph
        g, capture_ms = timed_ms(lambda: Graphed(cycle, *args))
        n_out = check_bitwise(g(), eager, f"{family}: graphed cycle")
        graph_ms = [timed_ms(g)[1] for _ in range(FAMILY_REPLAYS)]
        captured = dict(g.captured_launches)
        g.close()
        check(captured == counts, f"{family}: captured launches {captured} "
              f"!= eager {counts}")

        # 4. the kernels at Adam's shapes
        if family == "adam":
            rows = kc.check_recorded_calls(
                kc.record_kernel_calls(lambda: cycle(*args)), "adam")
            shapes = {(r["kernel"], tuple(r["shape"][1:])) for r in rows}
            check({("gtwg", (128, 640)), ("ipm_iter", (128, 640, 28))}
                  <= shapes, f"adam: the kernels at [512, 128, 640, p=28] "
                  f"{sorted(shapes)}")
            krows += rows

        # 5. card against CPU
        cmp = family_card_vs_cpu(family, cfg)
        accept = float(gres.accepted.float().mean())
        times[family] = dict(init_ms=init_ms, eager_cycle_ms=eager_ms,
                             graphed_cycle_ms=graph_ms, capture_ms=capture_ms,
                             init_solved_frac=init_frac,
                             cycle_solved_frac=float(frac),
                             accept_rate=accept)
        print(f"[families] {family} ({card}); batch {B}, N={cfg.num_nodes}, "
              f"E={cfg.num_ee}, float32: create_initial_run "
              f"({cfg.init_run_iters} SQP iterations) {init_ms:.0f} ms, "
              f"solved_frac {init_frac:.4f}, launches {init_launches}; one "
              f"cycle (FREQ={FREQ}) eager {eager_ms:.1f} ms, capture (2 "
              f"warm-up calls included) {capture_ms:.0f} ms, graphed "
              f"{', '.join(f'{t:.1f}' for t in graph_ms)} ms, replay vs "
              f"eager bit for bit on all {n_out} outputs; solved_frac "
              f"{float(frac):.4f}, gait accept rate {accept:.3f}; launches "
              f"a cycle {counts}; card vs CPU, 2 scenarios: {cmp}",
              flush=True)
    print(f"[families] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, krows, times


def family_card_vs_cpu(family: str, cfg) -> str:
    """Two scenarios of phase 11's start, made once in float64 and handed
    to three runs of :func:`family_run` (the cold start, then one cycle):
    on the card in float32, on the CPU in float64 and in float32.  The
    planned COM positions and the costs (the cold start's, the gait
    update's embedded RTI's) of the card are held to float64 within 10x
    the CPU float32 run's distance (phase 9's rule: at least TOL_BASE for
    positions, TOL_OBJ relative for costs); the card's solved flags (the
    cold start's, the cycle's RTIs', the embedded RTI's) equal the float64
    run's."""
    import torch
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    pr64 = family_problem(family, cfg, 2, "cpu", torch.float64)
    runs = {}
    for key, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu32", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        def conv(a):
            return (a.to(device=dev, dtype=dtype) if a.is_floating_point()
                    else a.to(dev))
        st, stats, (st2, solved, gres, _) = family_run(cfg,
                                                       tree_map(conv, pr64))
        runs[key] = dict(
            positions=torch.stack([st.traj.x_man[..., :3],
                                   st2.traj.x_man[..., :3]]).double().cpu(),
            costs=torch.stack([stats.cost, gres.rti_stats.cost]
                              ).double().cpu(),
            solved=torch.cat([stats.solved[None], solved,
                              gres.rti_stats.solved[None]]).cpu())
    r64 = runs["cpu64"]
    check(torch.equal(runs["card"]["solved"], r64["solved"]),
          f"{family} card vs CPU: solved flags {runs['card']['solved']} != "
          f"float64's {r64['solved']}")
    d_card, d32 = (float(torch.amax(torch.abs(runs[k]["positions"]
                                              - r64["positions"])))
                   for k in ("card", "cpu32"))
    tol = max(10.0 * d32, TOL_BASE)
    check(d_card <= tol, f"{family} card vs CPU, planned positions: "
          f"{d_card:.3e} > {tol:.3e}")
    rel, rel32 = (float(torch.amax(torch.abs(runs[k]["costs"] - r64["costs"])
                                   / torch.clamp_min(r64["costs"].abs(), 1.0)))
                  for k in ("card", "cpu32"))
    tol_c = max(10.0 * rel32, TOL_OBJ)
    check(rel <= tol_c, f"{family} card vs CPU, cost rel {rel:.3e} > "
          f"{tol_c:.3e}")
    return (f"planned positions max|card - cpu64| {d_card:.3e} m (cpu32 "
            f"{d32:.3e}; limit {tol:.3e}); costs rel {rel:.3e} (cpu32 "
            f"{rel32:.3e}; limit {tol_c:.3e}); costs card "
            f"{runs['card']['costs'].tolist()} cpu64 "
            f"{r64['costs'].tolist()}; solved flags equal")


# ---------------------------------------------------------------------------
# phase 12: the hardware loop
# ---------------------------------------------------------------------------

HW_TICKS = 250          # 5 MPC updates (ticks 0, 50, ..., 200); the gait
                        # update at the third and the fifth
HW_CONTROL_HZ = 1000.0  # scripts/hardware_sim_demo.py's control rate
HW_TORQUE_LIMIT = 33.5  # N m, the demo's torque limit and motor clip
HW_GAIT_EVERY = 2       # the gait update in place of every 2nd RTI
HW_MOCAP_EVERY = 4      # the mocap update every 4th tick (the demo's 240 Hz)
HW_CMP_TICKS = 50       # card against CPU: the first MPC period's commands
HW_FREE_S = 0.5         # the free-running HardwareRobot.run
HW_LOG_DECIMATION = 10
TOL_CMD = 0.01          # floor of the card-vs-CPU command distance


def hardware_configs():
    """scripts/hardware_sim_demo.py's configuration: (MPCConfig,
    WBQPConfig, SimConfig); the robot side's physics is the port's
    penalty-ground engine (MuJoCo in the demo)."""
    from bilevel_gait_gen_tpu_torch.control.wbqp import WBQPConfig
    from bilevel_gait_gen_tpu_torch.sim.engine import SimConfig
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    cfg = MPCConfig(ipm_iters=18, double_support=0.1, force_carrier=True,
                    carrier_ramp=0.1).validate()
    return cfg, WBQPConfig(), SimConfig()


def hardware_start(cfg, sim, device, dtype):
    """The demo's start for one robot (:62-80): the settled stand, the trot,
    a cold solver state and ``create_initial_run``.  Returns (model, params,
    state [1], q0 [nq], x_des [1, 12])."""
    import torch
    from bilevel_gait_gen_tpu_torch.control import mpc_controller
    from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
    from bilevel_gait_gen_tpu_torch.mpc import gait, solver
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
    from bilevel_gait_gen_tpu_torch.sim import engine
    model = a1.make_a1(device=device)
    stand = torch.tensor(a1.stand_config(), dtype=dtype, device=device)
    q0 = engine.settled_stand(model, sim, stand)
    params = srb.make_srb_params(model, q0)
    x0 = mpc_controller.reconstruct_srb_state(model, params, q0,
                                              torch.zeros_like(q0[1:]))
    feet0 = rbd.ee_positions(model, q0)
    traj = default_trajectory(cfg, gait.make_trot(cfg, dtype=dtype,
                                                  device=device),
                              x0[None], feet0[None, :, :2])
    st = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    x_des = srb.manifold_to_tangent(x0)[None]
    st, stats = solver.create_initial_run(cfg, params, st, x0[None],
                                          feet0[None], x_des)
    check(bool(stats.solved.all()), "the hardware loop's initial run solved")
    return model, params, st, q0, x_des


class HardwareMPC:
    """The control_fn of scripts/hardware_sim_demo.py (:96-129) from the
    port, for ``control.hardware.HardwareRobot``: the full configuration
    from the mocap base position, the IMU quaternion and the joints on the
    wire; an MPC update every ``cfg.dt`` (``sim/engine.mpc_update`` with
    the schedule sync on: the gait update in place of every
    ``gait_opt_every``-th RTI, as ``engine.closed_loop`` does), and on every
    tick ``control_action_full``.  Every update records its row in a
    ``utils/stats`` ring on the device; the ring's time column holds the
    wall time of the update before (a graph cannot time itself).

    On the card each of the RTI update, the gait update and the control
    tick is one ``utils/graphs.Graphed`` at batch 1, captured at its first
    use and held to that use's eager call bit for bit.  Exceptions raised
    in the callback are kept in :attr:`errors` before HardwareRobot's
    fall-back to Stand sees them."""

    def __init__(self, model, params, cfg, wb, x_des, *, gait_opt_every,
                 ring_capacity=64):
        import torch
        self.model, self.params, self.cfg, self.wb = model, params, cfg, wb
        self.x_des, self.gait_opt_every = x_des, gait_opt_every
        from bilevel_gait_gen_tpu_torch.utils.graphs import FirstUseGraphs
        self.dtype, self.device = x_des.dtype, x_des.device
        self.ring_capacity = ring_capacity
        self.fns = {"rti": self._update_fn(False),
                    "gait": self._update_fn(True), "tick": self._tick}
        self.runs = FirstUseGraphs(self.device)
        self.errors = []
        self.zero = torch.zeros(1, dtype=self.dtype, device=self.device)

    def reset(self, state, q_full, v_full, contact):
        """A fresh run from ``state``: no update made yet."""
        import torch
        from bilevel_gait_gen_tpu_torch.utils import stats as stats_mod
        self.st = state
        self.trust = torch.full((1,), self.cfg.trust_region,
                                dtype=self.dtype, device=self.device)
        self.t0, self.t0_t = 0.0, self.zero
        self.n_mpc, self.fails = 0, 0
        self.q_full, self.v_full, self.contact = q_full, v_full, contact
        self.ring = stats_mod.make_ring(self.ring_capacity, self.dtype,
                                        self.device)
        self.updates = []          # (kind, wall ms, stats row) an update
        self.last_ms = 0.0

    def _update_fn(self, gait: bool):
        from bilevel_gait_gen_tpu_torch.models import rbd
        from bilevel_gait_gen_tpu_torch.sim import engine
        from bilevel_gait_gen_tpu_torch.utils import stats as stats_mod

        def update(st, trust, q, v, t, mc, ring, idx, time_ms):
            feet = rbd.ee_positions(self.model, q)
            # mpc_update reads the loop state's q, v, st and trust
            ls = engine.LoopState(q=q, v=v, st=st, t0=t, mc=mc, trust=trust,
                                  tick=idx)
            st2, stats, trust2 = engine.mpc_update(
                self.model, self.params, self.cfg, ls, t, self.x_des, feet,
                mc, gait=gait, contact_sync=True)
            return st2, stats, trust2, stats_mod.record(ring, idx, time_ms,
                                                        stats)
        update.__name__ = "gait_update" if gait else "rti_update"
        return update

    def _tick(self, traj, q, v, t, t0, mc):
        from bilevel_gait_gen_tpu_torch.control import mpc_controller
        return mpc_controller.control_action_full(
            self.model, self.params, self.cfg, self.wb, traj, q, v, t, t0,
            mc)

    def run(self, name, *args):
        """``fns[name](*args)``: eagerly on the CPU; on the card through its
        graph, captured at the first call and held there to the eager
        call (:attr:`runs`)."""
        return self.runs(name, self.fns[name], *args)

    def __call__(self, q_j, dq, quat, gyro, vcom, t, mode):
        try:
            return self._control(q_j, dq, quat, gyro, vcom, t)
        except Exception as exc:
            self.errors.append(exc)
            raise

    def _control(self, q_j, dq, quat, gyro, vcom, t):
        import torch
        from bilevel_gait_gen_tpu_torch.sim import engine
        dev, dtype = self.device, self.dtype
        qj = torch.tensor(np.concatenate([self.q_full[0:3], quat, q_j]),
                          dtype=dtype, device=dev)[None]
        vj = torch.tensor(np.concatenate([vcom, gyro, dq]), dtype=dtype,
                          device=dev)[None]
        tt = torch.tensor([t], dtype=dtype, device=dev)
        mc = torch.tensor(np.asarray(self.contact, bool), device=dev)[None]
        if self.n_mpc == 0 or t >= self.t0 + self.cfg.dt:
            gait = engine.is_gait_period(self.n_mpc, self.gait_opt_every)
            idx = torch.tensor(self.n_mpc, dtype=torch.int32, device=dev)
            ms_in = torch.tensor(self.last_ms, dtype=dtype, device=dev)
            t_up = time.perf_counter()
            st, stats, trust, ring = self.run(
                "gait" if gait else "rti", self.st, self.trust, qj, vj, tt,
                mc, self.ring, idx, ms_in)
            row = torch.stack([stats.defect_l1, stats.step_norm,
                               stats.alpha, stats.cost, stats.merit,
                               stats.qp_gap, stats.qp_pri, stats.qp_dua,
                               stats.solved.to(dtype)], -1)[0]
            row = row.cpu().numpy()          # waits for the update
            self.last_ms = (time.perf_counter() - t_up) * 1e3
            self.updates.append(("gait" if gait else "rti", self.last_ms,
                                 row))
            self.st, self.trust, self.ring = st, trust, ring
            self.t0, self.t0_t = t, tt
            self.n_mpc += 1
            self.fails += int(row[-1] == 0)
        tau, q_des, dq_des, contact = self.run("tick", self.st.traj, qj, vj,
                                               tt, self.t0_t, mc)
        return (tau[0].cpu().numpy(), q_des[0].cpu().numpy(),
                dq_des[0].cpu().numpy(), contact[0].cpu().numpy())

    def close(self):
        self.runs.close()


class PenaltyGroundRobot:
    """The demo's robot MCU (:131-166) on the port's penalty-ground engine
    in place of MuJoCo: it streams state packets, takes the command packet,
    applies the motor PD law tau = tau_ff + kp (q_des - q) + kd (dq_des -
    dq) clipped to the torque limit, and steps ``sim.substeps`` physics
    steps over one control period; the measured contact is the engine's
    hysteresis latch.  On the card the physics of a tick is one graph."""

    def __init__(self, model, sim, q0, *, control_dt):
        import torch
        from bilevel_gait_gen_tpu_torch.models import rbd
        self.model, self.sim, self.control_dt = model, sim, control_dt
        self.q = q0[None].clone()
        self.v = torch.zeros(1, model.nv, dtype=q0.dtype, device=q0.device)
        self.mc = rbd.ee_positions(model, self.q)[..., 2] < (
            sim.foot_radius + sim.contact_enter_margin)
        self.graph = None
        self._read()

    def _physics(self, q, v, tau, mc):
        from bilevel_gait_gen_tpu_torch.models import rbd
        from bilevel_gait_gen_tpu_torch.sim import engine
        for _ in range(self.sim.substeps):
            q, v = engine.physics_step(self.model, self.sim, q, v, tau,
                                       self.control_dt / self.sim.substeps)
        return q, v, engine.latch_contact(self.sim,
                                          rbd.ee_positions(self.model, q), mc)

    def _read(self):
        self.q_np = self.q[0].double().cpu().numpy()
        self.v_np = self.v[0].double().cpu().numpy()
        self.mc_np = self.mc[0].cpu().numpy()

    def state_packet(self, seq: int) -> bytes:
        from bilevel_gait_gen_tpu_torch.control import hardware as hw
        q, v = self.q_np, self.v_np
        return hw.pack_state(seq, q[7:], v[6:], np.zeros(len(q) - 7),
                             q[3:7], v[3:6], np.zeros(3))

    def apply(self, cmd: bytes) -> np.ndarray:
        """The motor PD law on a command packet, then one control period of
        physics; returns the motor torques."""
        nj = len(self.q_np) - 7
        q_des, dq_des, kp, kd, tau_ff = np.frombuffer(
            cmd[8:], np.float32).reshape(nj, 5).T
        tau = np.clip(tau_ff + kp * (q_des - self.q_np[7:])
                      + kd * (dq_des - self.v_np[6:]),
                      -HW_TORQUE_LIMIT, HW_TORQUE_LIMIT)
        self.advance(tau)
        return tau

    def advance(self, tau: np.ndarray) -> None:
        """One control period of physics under the joint torques tau."""
        import torch
        from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
        tau_t = torch.tensor(tau, dtype=self.q.dtype,
                             device=self.q.device)[None]
        if self.q.is_cuda:
            if self.graph is None:
                eager = self._physics(self.q, self.v, tau_t, self.mc)
                self.graph = Graphed(self._physics, self.q, self.v, tau_t,
                                     self.mc)
                check_bitwise(self.graph(self.q, self.v, tau_t, self.mc),
                              eager, "graphed robot physics")
            else:
                self.graph(self.q, self.v, tau_t, self.mc)
            self.q, self.v, self.mc = (t.clone() for t in self.graph.out)
        else:
            self.q, self.v, self.mc = self._physics(self.q, self.v, tau_t,
                                                    self.mc)
        self._read()

    def close(self):
        if self.graph is not None:
            self.graph.close()
            self.graph = None


class TimedEndpoint:
    """A UDP endpoint whose recv and send are timed as stages."""

    def __init__(self, ep, timers):
        self.ep, self.timers = ep, timers

    def recv(self, maxlen: int = 2048):
        with self.timers.stage("recv"):
            return self.ep.recv(maxlen)

    def send(self, data: bytes) -> int:
        with self.timers.stage("send"):
            return self.ep.send(data)


def poll(fn, what: str, deadline_s: float = 2.0):
    """``fn()`` again until it gives something other than None or False,
    at most ``deadline_s`` seconds."""
    t_end = time.perf_counter() + deadline_s
    while True:
        got = fn()
        if got is not None and got is not False:
            return got
        check(time.perf_counter() < t_end, f"{what} within {deadline_s} s")
        time.sleep(1e-5)


def hardware_loop(ctrl, model, sim, q0, state, *, n_ticks, log_path=None,
                  timers=None):
    """The demo's lockstep loop (:131-166) over a loopback UdpEndpoint pair
    on ports the OS chose: each tick the robot streams its state packet
    (a mocap update every HW_MOCAP_EVERY-th tick), the controller's
    ``HardwareRobot.step_once`` answers with a command, the robot applies
    it and steps its physics.  Returns (commands [n_ticks, nj, 5] as sent,
    the robot's final q [nq], ms of each tick's step_once, whether each
    tick made an MPC update)."""
    from bilevel_gait_gen_tpu_torch import runtime
    from bilevel_gait_gen_tpu_torch.control import hardware as hw
    from bilevel_gait_gen_tpu_torch.utils.timing import StageTimers
    timers = timers or StageTimers()
    dt = 1.0 / HW_CONTROL_HZ
    robot = PenaltyGroundRobot(model, sim, q0, control_dt=dt)
    ctrl_ep, robot_ep = runtime.loopback_pair()
    nj = model.num_joints
    bot = hw.HardwareRobot(
        nj, TimedEndpoint(ctrl_ep, timers), ctrl,
        est_cfg=hw.EstimatorConfig(control_hz=HW_CONTROL_HZ),
        torque_limit=HW_TORQUE_LIMIT, stand_config=robot.q_np[7:].copy(),
        log_path=log_path, log_decimation=HW_LOG_DECIMATION)
    bot.set_mode(hw.Mode.MPC)
    joint_velocities = bot.estimator.joint_velocities

    def estimate(dq_raw):
        with timers.stage("estimate"):
            return joint_velocities(dq_raw)

    bot.estimator.joint_velocities = estimate
    control_fn = bot.control_fn

    def control(*args):
        with timers.stage("control"):
            return control_fn(*args)

    bot.control_fn = control
    ctrl.reset(state, robot.q_np, robot.v_np, robot.mc_np)
    cmds, tick_ms, updated = [], [], []
    try:
        for k in range(n_ticks):
            t = k * dt
            ctrl.q_full, ctrl.v_full = robot.q_np, robot.v_np
            ctrl.contact = robot.mc_np
            if k % HW_MOCAP_EVERY == 0:
                bot.estimator.mocap_update(robot.q_np[0:3].copy(), t)
            robot_ep.send(robot.state_packet(k))
            n_mpc, t_tick = ctrl.n_mpc, time.perf_counter()
            poll(lambda: bot.step_once(t), f"tick {k}: the state packet")
            tick_ms.append((time.perf_counter() - t_tick) * 1e3)
            updated.append(ctrl.n_mpc != n_mpc)
            check(bot.mode == hw.Mode.MPC, f"tick {k}: HardwareRobot fell "
                  f"back to {bot.mode} ({ctrl.errors[-1:]!r})")
            cmd = poll(lambda: robot_ep.recv(4096),
                       f"tick {k}: the command packet")
            cmds.append(np.frombuffer(cmd[8:], np.float32).reshape(nj, 5))
            robot.apply(cmd)
        q_end = robot.q_np.copy()
    finally:
        bot.stop()
        robot.close()
    return np.stack(cmds), q_end, np.asarray(tick_ms), np.asarray(updated)


def free_run(ctrl, model, sim, q0, state):
    """``HardwareRobot.run(HW_FREE_S, rate_hz=HW_CONTROL_HZ)`` in a thread
    while a robot thread streams held state packets (every 1 ms) and
    drains the commands: (ticks, overruns, commands received, step_once
    ms per tick)."""
    import threading
    from bilevel_gait_gen_tpu_torch import runtime
    from bilevel_gait_gen_tpu_torch.control import hardware as hw
    robot = PenaltyGroundRobot(model, sim, q0, control_dt=1.0 / HW_CONTROL_HZ)
    ctrl_ep, robot_ep = runtime.loopback_pair()
    bot = hw.HardwareRobot(
        model.num_joints, ctrl_ep, ctrl,
        est_cfg=hw.EstimatorConfig(control_hz=HW_CONTROL_HZ),
        torque_limit=HW_TORQUE_LIMIT, stand_config=robot.q_np[7:].copy())
    bot.set_mode(hw.Mode.MPC)
    ctrl.reset(state, robot.q_np, robot.v_np, robot.mc_np)
    step_once, lat = bot.step_once, []

    def timed_step(t):
        t_in = time.perf_counter()
        ok = step_once(t)
        if ok:
            lat.append((time.perf_counter() - t_in) * 1e3)
        return ok

    bot.step_once = timed_step
    stop, received = threading.Event(), [0]
    pkt = robot.state_packet(0)

    def stream():
        while not stop.is_set():
            robot_ep.send(pkt)
            while robot_ep.recv(4096) is not None:
                received[0] += 1
            time.sleep(1e-3)

    streamer = threading.Thread(target=stream)
    runner = threading.Thread(target=bot.run, args=(HW_FREE_S,),
                              kwargs={"rate_hz": HW_CONTROL_HZ})
    streamer.start()
    try:
        runner.start()
        runner.join(timeout=120.0)
        check(not runner.is_alive(), "HardwareRobot.run ended")
    finally:
        stop.set()
        streamer.join(timeout=10.0)
        bot.stop()
    check(not streamer.is_alive(), "the robot thread ended")
    check(bot.mode == hw.Mode.MPC, f"free run: HardwareRobot fell back to "
          f"{bot.mode} ({ctrl.errors[-1:]!r})")
    return bot.ticks, bot.overruns, received[0], np.asarray(lat)


def hardware_card_vs_cpu(cfg, wb, sim, start64, card_cmds) -> str:
    """The first HW_CMP_TICKS commands of the card's run (float32) against
    the same lockstep loop from the same float64 start on the CPU, in
    float64 and in float32: each command field held to float64 within 10x
    the CPU float32 run's own distance (at least TOL_CMD; kp and kd are
    exact)."""
    import torch
    from bilevel_gait_gen_tpu_torch.models import a1
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    _, params, st, q0, x_des = start64
    runs = {}
    for key, dtype in (("cpu64", torch.float64), ("cpu32", torch.float32)):
        def conv(a):
            return a.to(dtype) if a.is_floating_point() else a
        model = a1.make_a1(device="cpu")
        ctrl = HardwareMPC(model, tree_map(conv, params), cfg, wb,
                           conv(x_des), gait_opt_every=HW_GAIT_EVERY)
        runs[key] = hardware_loop(ctrl, model, sim, conv(q0),
                                  tree_map(conv, st),
                                  n_ticks=HW_CMP_TICKS)[0]
    runs["card"] = card_cmds[:HW_CMP_TICKS]
    parts = []
    for j, name in enumerate(("q_des", "dq_des", "kp", "kd", "tau_ff")):
        ref = runs["cpu64"][..., j].astype(np.float64)
        d_card = float(np.abs(runs["card"][..., j] - ref).max())
        d32 = float(np.abs(runs["cpu32"][..., j] - ref).max())
        tol = max(10.0 * d32, TOL_CMD)
        check(d_card <= tol, f"card vs CPU, the commands' {name}: "
              f"{d_card:.3e} > {tol:.3e}")
        parts.append(f"{name} {d_card:.3e} (cpu32 {d32:.3e}; limit "
                     f"{tol:.3e})")
    return "max|card - cpu64| over " + str(HW_CMP_TICKS) + " ticks: " + \
        "; ".join(parts)


def phase_hardware(card: str):
    """Phase 12: the hardware stack with the port's MPC on the card, the
    counterpart of scripts/hardware_sim_demo.py --trot at batch 1, float32,
    A1: ``control.hardware.HardwareRobot`` (the estimator, the gain
    schedule, the torque check, the wire format) in ``Mode.MPC`` over a
    loopback ``runtime.UdpEndpoint`` pair, its control_fn
    :class:`HardwareMPC`, the robot side :class:`PenaltyGroundRobot`.

    1. HW_TICKS ticks in lockstep, the kernels' counts set to 0 before and
       read after: every command finite, no fall-back to Stand, the base
       above 0.55 of its start height at the end; the gait update's graph
       launched ``gtwg`` and ``ipm_iter`` at its capture and none of
       ``rgemm``, ``chol_inverse``, ``gj_inverse``; every graph's first
       replay equal to its eager call bit for bit; the graphed control
       tick's device busy share under ``torch.profiler``.
    2. The kernels held to their plain versions on the gait update's own
       calls (``ops/kernel_checks``).
    3. The host utilities on the card: the stats ring's rows against the
       stats read back, its table printed; the HardwareRobot's LowLevelLog
       read back against the commands sent; the final SolverState saved
       and loaded back bit for bit; ``timing.device_trace`` around one
       gait update names ``gtwg_kernel`` and ``ipm_iter_kernel``.
    4. Card against CPU: the first MPC period's commands.
    5. A free-running ``HardwareRobot.run`` (printed, not gated but for the
       fall-back): ticks against HW_FREE_S x HW_CONTROL_HZ, overruns, tick
       latency.
    Returns (launches of step 1, kernel rows of step 2)."""
    import json as json_mod
    import shutil
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.utils import (checkpoint, lowlevel_log,
                                                  timing)
    from bilevel_gait_gen_tpu_torch.utils import stats as stats_mod
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    from bilevel_gait_gen_tpu_torch.models import a1
    t_phase = time.perf_counter()
    cfg, wb, sim = hardware_configs()
    out_dir = REPO / "smoke_out" / "hardware_loop"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    start64, start_ms = timed_ms(hardware_start, cfg, sim, "cpu",
                                 torch.float64)
    _, params, st, q0, x_des = start64

    def conv(a):
        return (a.to(device=DEVICE, dtype=torch.float32)
                if a.is_floating_point() else a.to(DEVICE))

    model = a1.make_a1(device=DEVICE)
    params, st, q0, x_des = (tree_map(conv, a) for a in (params, st, q0,
                                                           x_des))
    z0 = float(q0[2])
    ctrl = HardwareMPC(model, params, cfg, wb, x_des,
                       gait_opt_every=HW_GAIT_EVERY)

    # 1. the loop
    timers = timing.StageTimers()
    kernels.reset_launch_counts()
    t_loop = time.perf_counter()
    cmds, q_end, tick_ms, updated = hardware_loop(
        ctrl, model, sim, q0, st, n_ticks=HW_TICKS,
        log_path=str(out_dir / "lowlevel.bggl"), timers=timers)
    loop_s = time.perf_counter() - t_loop
    launches = kernels.launch_counts()
    check(not ctrl.errors, f"the controller raised {ctrl.errors!r}")
    check(bool(np.isfinite(cmds).all()), "every command finite")
    check(q_end[2] > 0.55 * z0, f"upright at the end: z {q_end[2]:.4f} m "
          f"against 0.55 x {z0:.4f}")
    kinds = [u[0] for u in ctrl.updates]
    check(kinds.count("gait") >= 1, f"a gait update ran: {kinds}")
    cap = ctrl.runs.graphs["gait"].captured_launches
    for name in ("gtwg", "ipm_iter"):
        check(cap[name] > 0, f"{name} launched at the gait update's "
              f"capture: {cap}")
    for name in ("rgemm", "chol_inverse", "gj_inverse"):
        check(cap[name] == 0 and launches[name] == 0,
              f"no {name} on the hardware loop: {cap}, {launches}")
    rti_cap = ctrl.runs.graphs["rti"].captured_launches
    check(all(v == 0 for v in rti_cap.values()),
          f"no kernel in the RTI update: {rti_cap}")
    busy = kc.profile_call(ctrl.runs.graphs["tick"],
                           "hardware loop control tick (graphed)")
    final_state = tree_map(torch.clone, ctrl.st)
    ring = tree_map(torch.clone, ctrl.ring)
    updates = list(ctrl.updates)

    # 2. the kernels on the gait update's own calls
    gait_args = ctrl.runs.first_args["gait"]
    calls = kc.record_kernel_calls(lambda: ctrl.fns["gait"](*gait_args))
    krows = kc.check_recorded_calls(calls, "hardware loop")
    for name in ("gtwg", "ipm_iter"):
        check(any(r["kernel"] == name for r in krows),
              f"{name} checked on the hardware loop's calls")

    # 3. the host utilities
    table = stats_mod.print_table(ring, last=len(updates),
                                  file=str(out_dir / "stats.txt"))
    n_rec = int(ring.head)
    check(n_rec == len(updates), f"{n_rec} stats rows for {len(updates)} "
          "updates")
    data = ring.data.cpu().numpy()
    want = np.stack([u[2] for u in updates]).astype(np.float32)
    got = np.stack([data[i % data.shape[0]] for i in range(n_rec)])
    check(np.array_equal(got[:, 0], np.arange(n_rec, dtype=np.float32)),
          "the ring's solve column")
    check(np.array_equal(got[:, 2:], want), "the ring's rows equal the "
          "stats read back")
    log = lowlevel_log.load(str(out_dir / "lowlevel.bggl"))
    rows = np.arange(0, HW_TICKS, HW_LOG_DECIMATION)
    check(log["tau"].shape == (len(rows), model.num_joints),
          f"log rows {log['tau'].shape}")
    check(np.array_equal(log["tau"], cmds[rows, :, 4]),
          "the log's torques equal the commands sent")
    check(np.array_equal(log["t"][:, 0], (rows * (1.0 / HW_CONTROL_HZ))
                         .astype(np.float32)), "the log's times")
    ck = str(out_dir / "state.npz")
    checkpoint.save(ck, final_state, metadata={"ticks": HW_TICKS})
    back = checkpoint.load(ck, tree_map(torch.zeros_like, final_state))
    n_leaves = check_bitwise(back, final_state, "checkpoint round trip")
    check(checkpoint.metadata(ck) == {"ticks": HW_TICKS},
          "checkpoint metadata")
    trace_dir = out_dir / "trace"
    with timing.device_trace(str(trace_dir)):
        ctrl.fns["gait"](*gait_args)
        torch.cuda.synchronize()
    traces = list(trace_dir.glob("trace_*.json"))
    check(len(traces) == 1, f"one trace written: {traces}")
    names = {e.get("name", "") for e in json_mod.loads(
        traces[0].read_text()).get("traceEvents", [])}
    for kname in ("gtwg_kernel", "ipm_iter_kernel"):
        check(any(kname in n for n in names), f"the trace names {kname}")
    trace_mb = traces[0].stat().st_size / 2 ** 20
    shutil.rmtree(trace_dir)

    # 4. card against CPU
    cmp = hardware_card_vs_cpu(cfg, wb, sim, start64, cmds)

    # 5. free running
    ticks, overruns, received, lat = free_run(ctrl, model, sim, q0, st)
    check(not ctrl.errors, f"the controller raised {ctrl.errors!r}")
    check(len(lat) > 0, "the free run made a tick")
    ctrl.close()

    ms = {k: [u[1] for u in updates if u[0] == k] for k in ("rti", "gait")}
    steady = tick_ms[~updated]
    solved = float(np.mean([u[2][-1] for u in updates]))
    print(f"[hardware] {card}; A1, batch 1, float32, N={cfg.num_nodes}, "
          f"{HW_TICKS} ticks at {HW_CONTROL_HZ:.0f} Hz in lockstep over "
          f"loopback UDP: start (settle, create_initial_run, CPU float64) "
          f"{start_ms:.0f} ms; loop {loop_s:.1f} s; MPC updates "
          f"{len(updates)} ({kinds}), solved share {solved:.3f}; final z "
          f"{q_end[2]:.4f} m (start {z0:.4f}); launches {launches}; "
          f"captured: gait {cap}", flush=True)
    print(f"[hardware] ms a control tick (step_once, ticks without an "
          f"update) median {float(np.median(steady)):.3f}, p90 "
          f"{float(np.percentile(steady, 90)):.3f}; RTI update graphed "
          f"{', '.join(f'{t:.1f}' for t in ms['rti'][1:])} ms (first use "
          f"{ms['rti'][0]:.0f} ms with eager call and capture; eager "
          f"{ctrl.runs.eager_ms['rti']:.1f} ms); gait update graphed "
          f"{', '.join(f'{t:.1f}' for t in ms['gait'][1:]) or '-'} ms "
          f"(first use {ms['gait'][0]:.0f} ms; eager "
          f"{ctrl.runs.eager_ms['gait']:.1f} ms); tick eager "
          f"{ctrl.runs.eager_ms['tick']:.1f} ms; replay vs eager bit for bit "
          f"{ctrl.runs.compared}; the graphed tick alone: device busy "
          f"{100 * busy['busy_share_of_wall']:.1f}% of {busy['wall_ms']:.2f} "
          f"ms ({busy['device_ops']} device operations)", flush=True)
    print("[hardware] stages over the loop:\n" + timers.summary(),
          flush=True)
    print(f"[hardware] stats ring ({n_rec} rows) equals the stats read "
          f"back:\n{table}", flush=True)
    print(f"[hardware] LowLevelLog: {len(rows)} rows read back equal the "
          f"commands sent; checkpoint: {n_leaves} leaves bit for bit; "
          f"trace: {trace_mb:.1f} MB naming gtwg_kernel and "
          f"ipm_iter_kernel", flush=True)
    print(f"[hardware] card vs CPU, the first MPC period from one float64 "
          f"start: {cmp}", flush=True)
    print(f"[hardware] free run HardwareRobot.run({HW_FREE_S}, rate_hz="
          f"{HW_CONTROL_HZ:.0f}): {ticks} ticks of "
          f"{int(HW_FREE_S * HW_CONTROL_HZ)}, RateLoop overruns {overruns}, "
          f"commands received {received}, step_once ms p50 "
          f"{float(np.median(lat)):.2f} p99 "
          f"{float(np.percentile(lat, 99)):.2f} (n {len(lat)})", flush=True)
    print(f"[hardware] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, krows


# ---------------------------------------------------------------------------
# phase 13: the golden rollout
# ---------------------------------------------------------------------------

GOLDEN_TOL_COSTS = 1e-2     # tests/test_parity.py's float32 bounds: costs
GOLDEN_TOL_X0 = 1e-3        # rtol and atol, the first step's state atol


def phase_golden(card: str):
    """Phase 13: the golden contract on the card, the counterpart of
    scripts/parity_tpu.py: ``golden.rollout`` (the initial SQP, 10 RTIs and
    the outer gradient of scripts/gen_golden.py, batch 1) in float32 on the
    card, eagerly, the kernels' counts set to 0 before and read after.
    Held to tests/golden/a1_trot.npz at parity_tpu.py's cost and cosine
    bounds and at tests/test_parity.py's float32 bounds (costs, the first
    step's state, the cosine and the dominant boundary's sign); its dx,
    dc and cos printed beside the CPU float32 rollout's own.  parity_tpu.py's
    dx < 5e-3 is printed, not gated: float32 rollouts miss it on the CPU in
    both packages (the merit line search flips after the first step,
    tests/test_parity.py:71-77).  The kernels' calls are recorded in the
    same run (the first of each kind and shape) and held to their plain
    versions after the counts are read.  Returns (launches, kernel
    rows)."""
    import torch
    from bilevel_gait_gen_tpu_torch import golden
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    gold = golden.load_golden()
    kernels.reset_launch_counts()
    out = {}
    calls = kc.record_kernel_calls(lambda: out.update(run=timed_ms(
        golden.rollout, torch.float32, DEVICE)))
    card_run, card_ms = out["run"]
    launches = kernels.launch_counts()
    for name in ("gtwg", "ipm_iter"):
        check(launches[name] > 0, f"the golden rollout launched {name}: "
              f"{launches}")
    t_cpu = time.perf_counter()
    cpu_run = golden.rollout(torch.float32, "cpu")
    cpu_s = time.perf_counter() - t_cpu
    rep = golden.parity_report(gold, card_run)
    rep_cpu = golden.parity_report(gold, cpu_run)
    xs, costs, grad, _ = card_run
    check(rep["finite"], "the card's rollout finite")
    check(rep["dc"] < golden.DC_BOUND, f"golden costs: rel {rep['dc']:.3e} "
          f">= {golden.DC_BOUND}")
    check(rep["cos"] > golden.COS_BOUND, f"golden gradient cosine "
          f"{rep['cos']:.5f} <= {golden.COS_BOUND}")
    check(np.allclose(costs, gold["costs"], rtol=GOLDEN_TOL_COSTS,
                      atol=GOLDEN_TOL_COSTS), "golden costs within "
          "test_parity's float32 bounds")
    dx0 = float(np.abs(xs[0] - gold["xs"][0]).max())
    check(dx0 <= GOLDEN_TOL_X0, f"golden first step: |dx| {dx0:.3e}")
    i = int(np.argmax(np.abs(gold["grad"])))
    g = grad.ravel()
    check(np.sign(g[i]) == np.sign(gold["grad"].ravel()[i])
          and abs(g[i]) > 0.3 * np.abs(g).max(),
          "the golden's dominant boundary keeps its sign and scale")
    per_step = np.abs(xs - gold["xs"]).max(1)
    print(f"[golden] {card}; A1 trot, N=20, batch 1, float32, eager: "
          f"rollout {card_ms / 1e3:.2f} s (CPU float32 {cpu_s:.2f} s); "
          f"launches {launches}", flush=True)
    print(f"[golden] card: dx {rep['dx']:.3e} (parity_tpu bound "
          f"{golden.DX_BOUND}; first step {dx0:.3e}), dc {rep['dc']:.3e} "
          f"(bound {golden.DC_BOUND}), cos {rep['cos']:.6f} (bound "
          f"{golden.COS_BOUND}), verdict {'OK' if rep['ok'] else 'FAIL'}; "
          f"CPU float32: dx {rep_cpu['dx']:.3e}, dc {rep_cpu['dc']:.3e}, "
          f"cos {rep_cpu['cos']:.6f}, verdict "
          f"{'OK' if rep_cpu['ok'] else 'FAIL'}; card |dx| by step "
          f"{np.array2string(per_step, precision=2)}", flush=True)
    # the kernels held to their plain versions on the rollout's own calls
    # (the outer gradient's cold forward solve, one problem, every sweep
    # exact), after the counts were read
    krows = kc.check_recorded_calls(calls, "golden rollout")
    for name in ("gtwg", "ipm_iter"):
        check(any(r["kernel"] == name for r in krows),
              f"{name} checked on the golden rollout's calls")
    return launches, krows


# ---------------------------------------------------------------------------
# phase 14: the closed-loop harness
# ---------------------------------------------------------------------------

CLH_SECONDS = 1.0        # simulated, at 1 kHz
CLH_INIT_VX = 0.375      # run_push_recovery's default
CLH_GAIT_FREQ = 5        # configs/a1_gait_opt.yaml:27
CLH_PUSH = (0.5, 0.3)    # (s, m/s) added to the base's forward velocity
CLH_CMP_TICKS = 250      # card against CPU: 5 MPC ticks, one a gait update
CLH_Z_MIN = 0.15         # m, ClosedLoopResult.recovered's upright bound


class PenaltyGroundPlant(PenaltyGroundRobot):
    """``MujocoLoop`` as the closed-loop harness needs it, on the port's
    penalty-ground engine (the card's machine has no MuJoCo): the joint
    torques applied as they come on every 1 ms tick, ``sim.substeps``
    physics steps a tick, the measured contact the engine's hysteresis
    latch; :meth:`run` logs (qs, vs, taus) as ``MujocoLoop.run`` does."""

    def __init__(self, model, sim, q0, v0, *, control_dt):
        import torch
        super().__init__(model, sim, q0, control_dt=control_dt)
        self.v = torch.as_tensor(v0, dtype=q0.dtype, device=q0.device)[
            None].clone()
        self._read()

    def contacts(self) -> np.ndarray:
        return self.mc_np.copy()

    def run(self, control_fn, n_steps: int):
        qs, vs, taus = [], [], []
        for k in range(n_steps):
            q, v = self.q_np.astype(np.float32), self.v_np.astype(np.float32)
            tau = np.asarray(control_fn(q, v, k * self.control_dt),
                             np.float64)
            self.advance(tau)
            qs.append(self.q_np.copy())
            vs.append(self.v_np.copy())
            taus.append(tau)
        return np.array(qs), np.array(vs), np.array(taus)

    def push(self, dvx: float) -> None:
        self.v[0, 0] += dvx
        self._read()


def harness_scenario(device):
    """The harness's scenario, ``sim/closed_loop.push_recovery_scenario`` at
    CLH_INIT_VX with the gait update every CLH_GAIT_FREQ-th MPC tick:
    (model, cfg, wb_cfg, q0, v0, the controller's keyword arguments)."""
    from bilevel_gait_gen_tpu_torch.sim import closed_loop as cl
    return cl.push_recovery_scenario(init_vx=CLH_INIT_VX,
                                     gait_opt_freq=CLH_GAIT_FREQ,
                                     device=device)


def harness_run(device, dtype, n_ticks, record_ticks=0):
    """The harness on ``device``: the port's ``ClosedLoopController`` behind
    :class:`PenaltyGroundPlant`, the push applied as ``run_closed_loop``
    applies it (the plant's velocity, then the clock shifted by the push
    time).  Returns (controller, qs, vs, taus, the first ``record_ticks``
    ticks' (q, v, t, contacts, tau, the plan and its t0 that the tick
    tracked, on the host), (ms, whether an MPC tick ran) a tick, the plan
    of the initial run on the host)."""
    import torch
    from bilevel_gait_gen_tpu_torch.sim.closed_loop import ClosedLoopController
    from bilevel_gait_gen_tpu_torch.sim.engine import SimConfig
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    model, cfg, wb, q0, v0, kw = harness_scenario(device)
    ctl = ClosedLoopController(model, cfg, wb, q0, v0, device=device,
                               dtype=dtype, **kw)
    plan0 = tree_map(lambda a: a.to("cpu", copy=True), ctl.state)
    plant = PenaltyGroundPlant(
        model, SimConfig(), torch.as_tensor(q0, device=device).to(dtype),
        v0, control_dt=0.001)
    record, ticks, plan = [], [], [None]

    def control_fn(q, v, t):
        mc = plant.contacts()
        n, t_in = ctl.n, time.perf_counter()
        tau = ctl(q, v, t, mc)
        ticks.append(((time.perf_counter() - t_in) * 1e3, ctl.n != n))
        if len(record) < record_ticks:
            if ctl.n != n:
                plan[0] = (tree_map(lambda a: a.to("cpu", copy=True),
                                    ctl.state.traj), ctl.t0)
            record.append((q, v, t, mc, tau, *plan[0]))
        return tau

    n1 = min(int(CLH_PUSH[0] * 1000), n_ticks)
    try:
        parts = [plant.run(control_fn, n1)]
        if n_ticks > n1:
            plant.push(CLH_PUSH[1])
            parts.append(plant.run(
                lambda q, v, t: control_fn(q, v, t + CLH_PUSH[0]),
                n_ticks - n1))
    finally:
        plant.close()
    qs, vs, taus = (np.concatenate(x) for x in zip(*parts))
    return ctl, qs, vs, taus, record, ticks, plan0


def harness_replay(record, plan0) -> tuple[dict, dict]:
    """The card's recorded ticks on the CPU, in float64 and float32: (the
    control ticks alone on the card's own plans, the whole controller from
    the card's initial plan ``plan0``), each the torques [T, nj] by run,
    "card" too.  The first takes the card's plan and t0 at each tick, so
    only the tick's own arithmetic differs; the second runs every MPC
    update again, and one float32 RTI already moves the plan that the
    torques track for the rest of the period."""
    import torch
    from bilevel_gait_gen_tpu_torch.sim.closed_loop import ClosedLoopController
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    card = np.stack([r[4] for r in record])
    ticks, loop = {"card": card}, {"card": card}
    for key, dtype in (("cpu64", torch.float64), ("cpu32", torch.float32)):
        def conv(a):
            return a.to(dtype) if a.is_floating_point() else a.clone()
        model, cfg, wb, q0, v0, kw = harness_scenario("cpu")
        ctl = ClosedLoopController(model, cfg, wb, q0, v0, device="cpu",
                                   dtype=dtype, **kw)
        out = []
        for q, v, t, mc, _, traj, t0 in record:
            out.append(ctl.fns["tick"](
                tree_map(conv, traj),
                torch.as_tensor(q).to(dtype)[None],
                torch.as_tensor(v).to(dtype)[None],
                torch.full((1,), t, dtype=dtype),
                torch.full((1,), t0, dtype=dtype),
                torch.as_tensor(np.asarray(mc, bool))[None])[0].numpy())
        ticks[key] = np.stack(out)
        ctl.state = tree_map(conv, plan0)
        loop[key] = np.stack([ctl(*r[:4]) for r in record])
        ctl.close()
    return ticks, loop


def harness_card_vs_cpu(record, plan0) -> str:
    """:func:`harness_replay`'s torques held tick for tick: the card's
    within 10x the CPU float32 run's distance to float64 (at least TOL_CMD,
    N m here), phase 12's rule at each tick, for the control ticks on the
    card's plans and for the whole controller."""
    ticks, loop = harness_replay(record, plan0)
    parts = []
    for what, runs in (("control ticks on the card's plans", ticks),
                       ("whole controller from the card's initial plan",
                        loop)):
        d_card = np.abs(runs["card"] - runs["cpu64"]).max(1)
        d32 = np.abs(runs["cpu32"] - runs["cpu64"]).max(1)
        lim = np.maximum(10.0 * d32, TOL_CMD)
        k = int(np.argmax(d_card / lim))
        check(bool(np.all(d_card <= lim)), f"harness card vs CPU, {what}: "
              f"tick {k}: |tau card - cpu64| {d_card[k]:.3e} N m > "
              f"{lim[k]:.3e}")
        d_c32 = np.abs(runs["card"] - runs["cpu32"]).max(1)
        parts.append(
            f"{what}: max|tau card - cpu64| {d_card.max():.3e} N m (cpu32 "
            f"{d32.max():.3e}), median {np.median(d_card):.3e} (cpu32 "
            f"{np.median(d32):.3e}); the tick nearest its limit {k}: "
            f"{d_card[k]:.3e} of {lim[k]:.3e}; max|tau card - cpu32| "
            f"{d_c32.max():.3e}")
    return f"over {len(record)} ticks: " + "; ".join(parts)


def phase_closed_loop_harness(card: str):
    """Phase 14: the closed-loop harness's controller on the card.  A1 at
    ``run_push_recovery``'s configuration and settled start, v0_x = 0.375,
    the gait update every fifth MPC tick (configs/a1_gait_opt.yaml), 1.0 s
    at 1 kHz: ``sim/closed_loop.ClosedLoopController`` in float32 on the
    card (its initial run, RTI, gait update and control tick each a CUDA
    graph captured at first use and held to the eager call bit for bit)
    behind :class:`PenaltyGroundPlant`, a push of +0.3 m/s at 0.5 s.

    1. The run, the kernels' counts set to 0 before and read after: every
       torque finite, the base above CLH_Z_MIN, a gait update ran (4 in
       1.0 s), every graph held to its eager first use; the gait update
       launched ``gtwg`` and ``ipm_iter``, and since the Raibert rows give
       its QP p = 56 equality rows, every sweep through the Schur stage
       (``rgemm`` x 2, ``chol_inverse``) and ``ipm_iter_handed_kernel``.
    2. The kernels held to their plain versions on the gait update's own
       calls (``ops/kernel_checks``; the Schur stage and the handed kernel
       by :func:`check_schur_stage`), timed.
    3. Card against CPU on the first CLH_CMP_TICKS ticks
       (:func:`harness_card_vs_cpu`).
    Prints n_mpc, n_fails, n_gait_accepts, mpc_ms and ctrl_ms.  Returns
    (launches, kernel rows)."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    n_ticks = int(CLH_SECONDS * 1000)
    kernels.reset_launch_counts()
    t_run = time.perf_counter()
    ctl, qs, vs, taus, record, ticks, plan0 = harness_run(
        DEVICE, torch.float32, n_ticks, record_ticks=CLH_CMP_TICKS)
    run_s = time.perf_counter() - t_run
    launches = kernels.launch_counts()
    res = ctl.result(qs, vs, taus)
    check(len(taus) == n_ticks, f"{len(taus)} ticks of {n_ticks}")
    check(bool(np.isfinite(taus).all()), "every torque finite")
    check(float(res.z.min()) > CLH_Z_MIN, f"upright: min z {res.z.min():.4f}"
          f" m")
    n_gait = res.n_mpc // CLH_GAIT_FREQ
    check(n_gait >= 1, f"a gait update ran ({res.n_mpc} MPC ticks)")
    for name in ("init_run", "rti", "gait", "tick"):
        check(ctl.runs.compared.get(name, 0) > 0, f"the {name} graph held "
              f"to its eager call: {ctl.runs.compared}")
    # the Raibert rows take the QP to p = 56 equality rows: every sweep of
    # the gait update runs the Schur stage and the handed iteration kernel
    by_kernel = dict(kernels.ipm_iter.launches_by_kernel)
    cap = ctl.runs.graphs["gait"].captured_launches
    for name in ("gtwg", "ipm_iter", "rgemm", "chol_inverse"):
        check(cap[name] > 0 and launches[name] > 0,
              f"{name} launched by the harness's gait update: {cap}")
    check(launches["gj_inverse"] == 0, f"no gj_inverse: {launches}")
    check(launches["rgemm"] == 2 * launches["chol_inverse"]
          == 2 * launches["ipm_iter"] and by_kernel == {
              "ipm_iter_kernel": 0,
              "ipm_iter_handed_kernel": launches["ipm_iter"]},
          f"every sweep through the Schur stage: {launches}, {by_kernel}")
    launches["ipm_iter_handed_kernel"] = by_kernel["ipm_iter_handed_kernel"]
    calls = kc.record_kernel_calls(
        lambda: ctl.fns["gait"](*ctl.runs.first_args["gait"]))
    krows = kc.check_recorded_calls(calls, "closed-loop harness")
    for name in ("gtwg", "ipm_iter"):
        check(any(r["kernel"] == name for r in krows),
              f"{name} checked on the harness's calls")
    # the stage and the handed kernel alone on each exact sweep's operands
    # (a Newton-Schulz sweep refreshes Mi inside the chain first)
    for key in [k for k in calls if k[0] == "ipm_iter" and not k[2]]:
        krows += [dict(r, kernel=r["name"], config="closed-loop harness")
                  for r in check_schur_stage(*calls[key],
                                             label="harness")]
    eager_ms = dict(ctl.runs.eager_ms)
    ctl.close()
    t_cmp = time.perf_counter()
    cmp = harness_card_vs_cpu(record, plan0)
    cmp_s = time.perf_counter() - t_cmp
    ms = np.asarray([m for m, _ in ticks])
    mpc = np.asarray([u for _, u in ticks])
    print(f"[harness] {card}; A1, run_push_recovery's configuration, "
          f"float32, batch 1, {n_ticks} ticks at 1 kHz on the penalty "
          f"ground, push +{CLH_PUSH[1]} m/s at {CLH_PUSH[0]} s: run "
          f"{run_s:.1f} s; n_mpc {res.n_mpc}, n_fails {res.n_fails}, "
          f"n_gait_accepts {res.n_gait_accepts} of {n_gait} gait updates; "
          f"mpc_ms {res.mpc_ms:.2f}, ctrl_ms {res.ctrl_ms:.2f} (means, first "
          f"uses with their eager calls and captures included); min z "
          f"{res.z.min():.4f} m, flight {res.flight_s:.3f} s; launches "
          f"{launches}; captured: gait {cap}", flush=True)
    print(f"[harness] ms a control call (controller only): ticks without "
          f"an MPC update median {float(np.median(ms[~mpc])):.3f}, p90 "
          f"{float(np.percentile(ms[~mpc], 90)):.3f}; with one, after the "
          f"first uses, median {float(np.median(ms[mpc][2:])):.2f}; eager "
          f"first uses ms {json.dumps({k: round(v, 1) for k, v in eager_ms.items()})}"
          f"; graphs held bit for bit {ctl.runs.compared}", flush=True)
    print(f"[harness] card vs CPU ({cmp_s:.1f} s): {cmp}", flush=True)
    print(f"[harness] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, krows


# ---------------------------------------------------------------------------
# phase 15: the demos
# ---------------------------------------------------------------------------

DEMO_BIG = ["128", "100", "--big"]   # batch_sim_demo --big: 2 periods of 50
DEMO_DIAG_TICKS = 500                # diag_engine: 10 periods of 50


def load_script(name: str):
    """``scripts/<name>.py`` of this checkout as a module (its ``main`` is
    not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def demo_plan_gap(card_run, cpu64, cpu32) -> str:
    """The mpc_demo's final plan (after the gait update) on the card held to
    the CPU float64 run: its cost and x_man within 10x the CPU float32 run's
    distance to float64 (at least TOL_CMD, phase 12's floor)."""
    parts = []
    for what, get in (("cost", lambda r: r.gait.cost),
                      ("x_man", lambda r: r.state.traj.x_man)):
        card, ref, f32 = (get(r).detach().cpu().double().numpy()
                          for r in (card_run, cpu64, cpu32))
        d_card = float(np.abs(card - ref).max())
        d32 = float(np.abs(f32 - ref).max())
        lim = max(10.0 * d32, TOL_CMD)
        check(d_card <= lim, f"mpc_demo card vs CPU float64, the final "
              f"plan's {what}: {d_card:.3e} > {lim:.3e} (CPU float32 "
              f"{d32:.3e})")
        parts.append(f"{what} {d_card:.3e} (CPU float32 {d32:.3e}, limit "
                     f"{lim:.3e})")
    return "; ".join(parts)


def eager_loop(loop: dict):
    """``engine.closed_loop``'s periods run eagerly on the arguments'
    device, as its CPU branch runs them: (final state, SimLog)."""
    import torch
    from bilevel_gait_gen_tpu_torch.sim import engine
    ls = engine.initial_state(loop["model"], loop["cfg"], loop["sim"],
                              loop["state0"], loop["q0"], loop["v0"])
    logs = []
    for start in range(0, loop["n_ticks"], loop["mpc_every"]):
        ls, log = engine.period(
            loop["model"], loop["params"], loop["cfg"], loop["wb_cfg"],
            loop["sim"], loop["x_des_tan"], ls,
            control_dt=loop["control_dt"],
            ticks=min(loop["mpc_every"], loop["n_ticks"] - start),
            gait=False, contact_sync=False)
        logs.append(log)
    return ls.st, engine.SimLog(*(torch.cat(f) for f in zip(*logs)))


def phase_demos(card: str):
    """Phase 15: the port's demo scripts on the card (scripts/torch_*.py;
    the three MuJoCo demos need MuJoCo, which the card's machine lacks).

    (a) scripts/torch_mpc_demo.py's path at full width, float32, batch 1,
        N=20, ipm_iters=18: the initial run, 20 RTIs and one gait update,
        each a CUDA graph captured at its first call and held to that
        call's eager result bit for bit (``utils/graphs.FirstUseGraphs``),
        the kernels' counts set to 0 before and read after and their calls
        recorded; the gait update's ``gtwg`` and ``ipm_iter`` calls held to
        their plain versions; the final plan's cost and x_man held to the
        CPU float64 run within 10x the CPU float32 run's gap.  No plot.
    (b) scripts/torch_batch_sim_demo.py with its defaults (standing, batch
        16, 100 ticks, mpc_every=12: 8 periods and a trailing one of 4
        ticks), graphed by ``engine.closed_loop``, against the same periods
        run eagerly on the card, bit for bit.
    (c) scripts/torch_batch_sim_demo.py --big at batch 128, 100 ticks: one
        run (its graph captured in it), the aggregate real-time factor and
        the upright count; the plan and the rollout finite.
    (d) scripts/torch_diag_engine.py at 500 ticks: its trace; the plan
        and the rollout (q, v, tau) finite.
    Returns (launches, kernel rows)."""
    import torch
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    t_phase = time.perf_counter()
    mpc_demo = load_script("torch_mpc_demo")
    batch_sim = load_script("torch_batch_sim_demo")
    diag = load_script("torch_diag_engine")

    # (a) the mpc_demo path
    cfg = MPCConfig(ipm_iters=18).validate()
    kernels.reset_launch_counts()
    out = {}
    t_a = time.perf_counter()
    calls = kc.record_kernel_calls(lambda: out.update(run=mpc_demo.solve(
        cfg, mpc_demo.N_ITERS, True, DEVICE)))
    a_s = time.perf_counter() - t_a
    launches = kernels.launch_counts()
    by_kernel = dict(kernels.ipm_iter.launches_by_kernel)
    run = out["run"]
    for name in ("gtwg", "ipm_iter"):
        check(launches[name] > 0, f"mpc_demo's gait update launched {name}:"
              f" {launches}")
    check(launches["gj_inverse"] == 0 and launches["chol_inverse"] == 0,
          f"mpc_demo: no gj_inverse, no Schur stage (p = 16): {launches}")
    for name in ("init_run", "rti", "gait"):
        check(run.graphs.compared.get(name, 0) > 0, f"mpc_demo: the {name} "
              f"graph held to its eager call: {run.graphs.compared}")
    check(finite_outputs(run.state.traj, run.gait.cost, run.gait.alpha,
                         run.gait.grad_norm),
          "mpc_demo: the final plan and the gait update's results finite")
    t_cpu = time.perf_counter()
    cpu64 = mpc_demo.solve(cfg, mpc_demo.N_ITERS, True, "cpu",
                           torch.float64)
    cpu32 = mpc_demo.solve(cfg, mpc_demo.N_ITERS, True, "cpu",
                           torch.float32)
    cpu_s = time.perf_counter() - t_cpu
    gap = demo_plan_gap(run, cpu64, cpu32)
    krows = kc.check_recorded_calls(calls, "mpc_demo")
    for name in ("gtwg", "ipm_iter"):
        check(any(r["kernel"] == name for r in krows),
              f"{name} checked on mpc_demo's calls")
    steady = run.rti_ms[1:]
    eager_ms = {k: round(v, 1) for k, v in run.graphs.eager_ms.items()}
    print(f"[demos] {card}; (a) mpc_demo, A1 trot, N=20, ipm_iters=18, "
          f"float32, batch 1: {a_s:.1f} s; RTIs avg "
          f"{float(np.mean(run.rti_ms)):.2f} ms (the first with its eager "
          f"call and capture {run.rti_ms[0]:.1f}), after it median "
          f"{float(np.median(steady)):.2f}, min {min(steady):.2f}, max "
          f"{max(steady):.2f}; gait update {run.gait_s * 1e3:.1f} ms with "
          f"its eager call "
          f"({run.graphs.eager_ms.get('gait', np.nan):.1f} ms) and capture; "
          f"eager first calls ms {json.dumps(eager_ms)}"
          f"; graphs held bit for bit {run.graphs.compared}; launches "
          f"{launches} ({by_kernel}); card vs CPU float64 ({cpu_s:.1f} s "
          f"on the CPU): {gap}", flush=True)

    # (b) batch_sim_demo's defaults: graphed against eager, bit for bit
    kernels.reset_launch_counts()
    t_b = time.perf_counter()
    demo = batch_sim.prepare([], DEVICE)
    loop = demo["loop"]
    check(loop["n_ticks"] % loop["mpc_every"] != 0,
          "batch_sim_demo's defaults end on a partial period")
    graphed, graphed_ms = timed_ms(batch_sim.simulate, demo)
    eager, eager_ms = timed_ms(eager_loop, loop)
    n_out = check_bitwise(graphed, eager, "batch_sim_demo graphed loop")
    z = graphed[1].q[..., 2]
    check(finite_outputs(graphed[0].traj, graphed[1].q, graphed[1].v,
                         graphed[1].tau),
          "batch_sim_demo: the plan and the rollout finite")
    print(f"[demos] (b) batch_sim_demo defaults, batch {demo['B']}, "
          f"{loop['n_ticks']} ticks, mpc_every={loop['mpc_every']} (the "
          f"last period {loop['n_ticks'] % loop['mpc_every']} ticks): "
          f"graphed {graphed_ms:.0f} ms (captures included), eager on the "
          f"card {eager_ms:.0f} ms; graphed vs eager bit for bit on all "
          f"{n_out} outputs; upright {int((z.amin(0) > 0.15).sum())}/"
          f"{demo['B']}; {time.perf_counter() - t_b:.1f} s", flush=True)

    # (c) batch_sim_demo --big at batch 128
    t_c = time.perf_counter()
    big = batch_sim.prepare(DEMO_BIG, DEVICE)
    (st_big, log_big), run_ms = timed_ms(batch_sim.simulate, big)
    check(finite_outputs(st_big.traj, log_big.q, log_big.v, log_big.tau),
          "batch_sim_demo --big: the plan and the rollout finite")
    z = log_big.q[..., 2]
    sim_s = big["n_ticks"] * big["control_dt"]
    print(f"[demos] (c) batch_sim_demo --big, batch {big['B']}, "
          f"{big['n_ticks']} ticks: one run {run_ms:.0f} ms, its graph "
          f"captured in it (the script's second, \"steady\" run captures "
          f"again); real-time factor {big['B'] * sim_s / run_ms * 1e3:.3f} "
          f"aggregate; upright {int((z.amin(0) > 0.15).sum())}/{big['B']}, "
          f"z final mean {float(z[-1].mean()):.3f}; "
          f"{time.perf_counter() - t_c:.1f} s", flush=True)

    # (d) diag_engine at 500 ticks
    t_d = time.perf_counter()
    st_d, log_d = diag.probe(DEMO_DIAG_TICKS, DEVICE)
    check(finite_outputs(st_d.traj, log_d.q, log_d.v, log_d.tau),
          "diag_engine: the plan and the rollout finite")
    print(f"[demos] (d) diag_engine, {DEMO_DIAG_TICKS} ticks: "
          f"{time.perf_counter() - t_d:.1f} s", flush=True)
    rest = kernels.launch_counts()
    launches = {k: launches[k] + rest[k] for k in launches}
    launches["ipm_iter_handed_kernel"] = by_kernel.get(
        "ipm_iter_handed_kernel", 0)
    print(f"[demos] launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, krows


# ---------------------------------------------------------------------------
# phase 16: parallel/ (the meshes, the alpha-sharded gait update) and the
# scripts on it
# ---------------------------------------------------------------------------

PAR_RANKS = 2            # processes that share the card in 16(a) and (c)
PAR_LOOP_BATCH = 64      # scenarios a process in 16(c)
PAR_LOOP = dict(n_ticks=40, control_dt=0.005, mpc_every=20)
PAR_REJECTION_BATCH = 256                      # 16(e)
PAR_SWEEP = ((128, 1024), ("xla", "pallas"))   # 16(f): batches, kernels
TOL_PAR_COST = 1e-3      # tests/test_parallel.py:101-107: cost rtol,
TOL_PAR_BOUNDS = 2e-3    # bounds atol (alpha equal)
TOL_PAR_TIE = 1e-5       # relative: two lanes this close are a tie of
                         # float32 rounding (counted and printed, not gated)
TOL_PAR_Q = 2e-2         # tests/test_parallel.py:171-199: q over the first
PAR_Q_TICKS = 10         # 10 ticks, and the z minima
PAR_Z_MIN = 0.10
PAR_XY_MAX = 0.25        # tests/test_parallel.py:193: final |x|, |y| [m]


def small_config():
    """tests/test_parallel.py:23-25's configuration."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                     samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                     init_run_iters=2, max_ls_iters=4, dt=0.05).validate()


def parallel_case(device):
    """Phase 16's inputs, float32.  (a): the bench problem (bench_config(),
    A1, N=20, ls_alphas=4) at batch 128 after one RTI, with t0 = 0 and the
    shared x_des [12].  (c): tests/test_parallel.py:171-199's loop, its
    small configuration, the settled stand, PAR_RANKS x PAR_LOOP_BATCH
    scenarios with forward velocities in linspace(-0.1, 0.1), a cold
    solver state."""
    import torch
    from bilevel_gait_gen_tpu_torch.control import wbqp
    from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
    from bilevel_gait_gen_tpu_torch.mpc import gait, solver
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    from bilevel_gait_gen_tpu_torch.sim import engine
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    cfg = bench_config()
    pr = make_problem(cfg, BATCH, device=device, dtype=torch.float32)
    st, _ = solver.solve_step(cfg, pr.params, pr.states, pr.x0s, pr.t0,
                              pr.feets, pr.x_des)
    gait_case = dict(cfg=cfg, params=pr.params, states=st, x0s=pr.x0s,
                     feets=pr.feets, x_des=pr.x_des[0].clone())

    scfg, B = small_config(), PAR_RANKS * PAR_LOOP_BATCH
    model = a1.make_a1(device=device)
    q0 = torch.tensor(a1.stand_config(), device=device).to(torch.float32)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0, torch.zeros(model.nv,
                                                       device=device))
    feet0 = rbd.ee_positions(model, q0)
    traj = default_trajectory(scfg, gait.make_trot(scfg, dtype=torch.float32,
                                                   device=device),
                              x0[None], feet0[None, :, :2])
    st1 = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [scfg.ee_box_size], device=device))
    sim = engine.SimConfig()
    v0s = torch.zeros(B, model.nv, device=device)
    v0s[:, 0] = torch.linspace(-0.1, 0.1, B, device=device)
    loop_case = dict(
        model=model, params=params, cfg=scfg, wb_cfg=wbqp.WBQPConfig(),
        sim=sim, states=tree_map(lambda a: a.repeat_interleave(B, 0), st1),
        q0s=engine.settled_stand(model, sim, q0).repeat(B, 1), v0s=v0s,
        xds=srb.manifold_to_tangent(x0).repeat(B, 1))
    return gait_case, loop_case


def record_lane_objectives(fn):
    """``fn()`` with the gait update's lane objectives recorded: (its
    result, [each ``bilevel._lane_objectives`` call's [B, lanes]])."""
    from bilevel_gait_gen_tpu_torch.mpc import bilevel
    inner, seen = bilevel._lane_objectives, []

    def recording(*args, **kw):
        out = inner(*args, **kw)
        seen.append(out.detach().clone())
        return out

    bilevel._lane_objectives = recording
    try:
        return fn(), seen
    finally:
        bilevel._lane_objectives = inner


def parallel_worker(rank: int, d: str) -> int:
    """One of phase 16's PAR_RANKS processes on the card (``gloo`` on a
    ``FileStore`` in ``d``; the parent built the kernels).  (a) the
    alpha-sharded gait update on the {scenario: 1, alpha: PAR_RANKS} mesh:
    one call with the kernels' counts (and ``ipm_iter``'s count by
    iteration kernel) set to 0 before and read after, its
    kernel calls and lane objectives recorded, then one timed call; the
    recorded calls held to their plain versions, one rank at a time.  (c)
    the scenario-sharded closed loop on a {scenario: PAR_RANKS} mesh, twice.
    Writes its local results to ``d``/rank<rank>.pt."""
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod
    from bilevel_gait_gen_tpu_torch.parallel import multihost
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    from bilevel_gait_gen_tpu_torch.utils.precision import set_fp32_precision
    set_fp32_precision()
    kernels.build()
    multihost.initialize(f"file://{d}/store", PAR_RANKS, rank,
                         device=DEVICE, backend="gloo")
    try:
        inp = torch.load(f"{d}/inputs.pt", map_location=DEVICE,
                         weights_only=False)
        a, lp = inp["gait"], inp["loop"]
        mesh = mesh_mod.make_mesh((1, PAR_RANKS), ("scenario", "alpha"),
                                  device=DEVICE)
        upd = mesh_mod.alpha_sharded_gait_opt_update(a["cfg"], a["params"],
                                                     mesh)
        args = (a["states"], a["x0s"], 0.0, a["feets"], a["x_des"])
        out = {}
        kernels.reset_launch_counts()
        calls = kc.record_kernel_calls(lambda: out.update(
            zip(("res", "lanes"), record_lane_objectives(lambda: upd(
                *args)))))
        launches = kernels.launch_counts()
        by_kernel = dict(kernels.ipm_iter.launches_by_kernel)
        launches["ipm_iter_handed_kernel"] = by_kernel.get(
            "ipm_iter_handed_kernel", 0)
        dist.barrier()
        _, upd_ms = timed_ms(upd, *args)
        dist.barrier()
        rows = []
        for r in range(PAR_RANKS):
            if r == rank:
                rows = kc.check_recorded_calls(calls,
                                               f"alpha-sharded rank {rank}")
            dist.barrier()

        mesh1 = mesh_mod.make_mesh((PAR_RANKS,), ("scenario",),
                                   device=DEVICE)
        loop = mesh_mod.scenario_sharded_closed_loop(
            lp["model"], lp["params"], lp["cfg"], lp["wb_cfg"], lp["sim"],
            mesh1, **PAR_LOOP)
        largs = (lp["states"], lp["q0s"], lp["v0s"], lp["xds"])
        runs, loop_ms = [], []
        for _ in range(2):
            dist.barrier()
            run, ms = timed_ms(loop, *largs)
            runs.append(tree_map(lambda x: x.to_local(), run))
            loop_ms.append(ms)
        torch.save(dict(res=tree_map(lambda x: x.to_local(), out["res"]),
                        lanes=out["lanes"], launches=launches,
                        by_kernel=by_kernel, rows=rows,
                        upd_ms=upd_ms, loop=runs, loop_ms=loop_ms),
                   f"{d}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def run_parallel_workers(gait_case, loop_case) -> list[dict]:
    """Phase 16's PAR_RANKS processes (``parallel_worker``, each a fresh
    interpreter: none is forked from this process, where CUDA is up); their
    output is printed; a process that fails makes the phase raise.  Returns
    each rank's results."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as d:
        torch.save(dict(gait=gait_case, loop=loop_case), f"{d}/inputs.pt")
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--parallel-rank",
             str(r), d], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(PAR_RANKS)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, o in enumerate(outs):
            print("".join(f"[parallel rank {r}] {ln}\n"
                          for ln in o.splitlines()[-40:]), end="", flush=True)
        check(all(p.returncode == 0 for p in procs),
              f"phase 16's processes exited {[p.returncode for p in procs]}")
        return [torch.load(f"{d}/rank{r}.pt", map_location=DEVICE,
                           weights_only=False) for r in range(PAR_RANKS)]


def lane_ties(lanes) -> np.ndarray:
    """Scenarios whose two best lane objectives are within TOL_PAR_TIE
    (relative) of each other."""
    o = np.sort(lanes.double().cpu().numpy(), axis=1)
    gap = o[:, 1] - o[:, 0]
    return np.isfinite(o[:, 1]) & (gap <= TOL_PAR_TIE * np.maximum(
        1.0, np.abs(o[:, 0])))


def check_alpha_sharded(res, ref, ties) -> str:
    """16(a)'s bounds outside the ties: alpha equal, cost within
    TOL_PAR_COST (relative), the bounds within TOL_PAR_BOUNDS."""
    keep = ~ties

    def np_(t):
        return t.detach().double().cpu().numpy()[keep]

    a, b = np_(res.alpha), np_(ref.alpha)
    check(np.array_equal(a, b), f"alpha-sharded: alpha differs at "
          f"{int((a != b).sum())} scenarios (no tie)")
    c, cr = np_(res.cost), np_(ref.cost)
    both_inf = np.isinf(c) & np.isinf(cr) & (np.sign(c) == np.sign(cr))
    dc = np.where(both_inf, 0.0, np.abs(c - cr) / np.maximum(np.abs(cr),
                                                              1e-30))
    check(bool((dc <= TOL_PAR_COST).all()),
          f"alpha-sharded: cost {dc.max():.3e} > {TOL_PAR_COST} (relative)")
    db = float(np.abs(np_(res.state.traj.sched.bounds)
                      - np_(ref.state.traj.sched.bounds)).max())
    check(db <= TOL_PAR_BOUNDS,
          f"alpha-sharded: bounds {db:.3e} > {TOL_PAR_BOUNDS}")
    return (f"alpha equal on {int(keep.sum())}, cost {float(dc.max()):.3e} "
            f"(<= {TOL_PAR_COST}), bounds {db:.3e} (<= {TOL_PAR_BOUNDS})")


def check_sharded_loop(loops, ref_log, part_logs) -> str:
    """16(c): tests/test_parallel.py:171-199's contract on the ranks' first
    loops put together on the scenario dimension (``loops``: each rank's
    two runs) against the unsharded loop (``ref_log``): q finite, q over
    the first PAR_Q_TICKS ticks within TOL_PAR_Q, z above PAR_Z_MIN, the
    final |x|, |y| below PAR_XY_MAX, every MPC tick solved, and each rank's
    second run bit for bit its first.  Each rank's loop is also held bit
    for bit to the unsharded loop of its own PAR_LOOP_BATCH scenarios
    (``part_logs``, one a rank): its shard is its slice.  The test's
    scenario-by-scenario tracking of the z minima (within TOL_PAR_Q) is
    printed, not gated: the loops of PAR_LOOP_BATCH and of PAR_RANKS x
    PAR_LOOP_BATCH scenarios differ from the first tick on, and which
    operation's result changes with the batch is not known (no trace has
    shown it)."""
    import torch
    log = [torch.cat(f, dim=1) for f in zip(*(lp[0][1] for lp in loops))]
    q, cost, solved = (log[i].double().cpu().numpy() for i in (0, 4, 5))
    qp = ref_log.q.double().cpu().numpy()
    check(q.shape == qp.shape, f"sharded loop: q {q.shape} for {qp.shape}")
    check(bool(np.isfinite(q).all()), "sharded loop: q finite")
    dq = float(np.abs(q[:PAR_Q_TICKS] - qp[:PAR_Q_TICKS]).max())
    check(dq <= TOL_PAR_Q, f"sharded loop: q over the first {PAR_Q_TICKS} "
          f"ticks {dq:.3e} from the unsharded > {TOL_PAR_Q}")
    zmin, zmin_p = q[:, :, 2].min(axis=0), qp[:, :, 2].min(axis=0)
    check(bool((zmin > PAR_Z_MIN).all()),
          f"sharded loop: z min {zmin.min():.3f} <= {PAR_Z_MIN}")
    xy = float(np.abs(q[-1, :, 0:2]).max())
    check(xy < PAR_XY_MAX,
          f"sharded loop: final |x|, |y| {xy:.3f} >= {PAR_XY_MAX}")
    check(bool(solved.astype(bool)[np.isfinite(cost)].all()),
          "sharded loop: every MPC tick solved")
    n_out = sum(check_bitwise(lp[1], lp[0], f"sharded loop rank {i} rerun")
                for i, lp in enumerate(loops))
    n_part = sum(check_bitwise(lp[0][1], part, f"sharded loop rank {i} "
                               f"against the unsharded loop of its "
                               f"scenarios")
                 for i, (lp, part) in enumerate(zip(loops, part_logs)))
    dz = float(np.abs(zmin - zmin_p).max())
    dq_all = np.abs(q - qp).max(axis=(1, 2))
    first = int(np.argmax(dq_all > 0)) if (dq_all > 0).any() else -1
    return (f"q over {PAR_Q_TICKS} ticks {dq:.3e} from the unsharded "
            f"(<= {TOL_PAR_Q}; over all {q.shape[0]} ticks "
            f"{dq_all.max():.3e}, the first tick that differs {first}), z min "
            f"{zmin.min():.3f} (> {PAR_Z_MIN}), final |x|, |y| max {xy:.3f} "
            f"(< {PAR_XY_MAX}), every MPC tick solved; each rank's rerun bit "
            f"for bit ({n_out} outputs); each rank bit for bit the unsharded "
            f"loop of its {PAR_LOOP_BATCH} scenarios ({n_part} outputs); not "
            f"gated: z minima {dz:.3e} from the unsharded's (the test's "
            f"{TOL_PAR_Q})")


def phase_parallel(card: str):
    """Phase 16: ``parallel/`` on the card and the scripts that stand on it.

    (a) ``mesh.alpha_sharded_gait_opt_update`` at bench width
        (``bench_config()``, A1, N=20, batch 128, ``ls_alphas=4``, float32)
        on a {scenario: 1, alpha: 2} mesh of two processes that share the
        card (``gloo``: NCCL refuses two ranks on one device), eagerly;
        each rank solves 2 of every scenario's 4 lanes, [256, 256, 1280,
        p=16].  Held to ``bilevel.gait_opt_update`` without a group on the
        same card and inputs at tests/test_parallel.py:101-107's bounds
        (alpha equal, cost rtol 1e-3, bounds atol 2e-3) outside the
        scenarios whose two best lane objectives are a float32 tie
        (counted, printed); both ranks' results bit for bit alike; each
        rank's ``gtwg`` and ``ipm_iter`` calls held to their plain versions
        (``launches_by_path["alpha_sharded"]``: both ranks' launches in
        one update, counts set to 0 before and read after).
    (b) the same function in a one-rank ``nccl`` group (a {1, 1} mesh of
        this process): bit for bit the update without a group.
    (c) ``mesh.scenario_sharded_closed_loop``: tests/test_parallel.py:
        171-199's loop (its small configuration, 40 ticks, mpc_every=20),
        two processes of 64 scenarios, held to the unsharded loop of 128 by
        that test's contract (``check_sharded_loop``), each process bit
        for bit its rerun and the unsharded loop of its 64 scenarios.
    (d) scripts/torch_multihost_demo.py (two processes on the card):
        MULTIHOST OK and the same mean cost on both.
    (e) scripts/torch_distr_rejection.py's default at batch 256, one
        process: its lines, the plan finite.
    (f) scripts/torch_bench_sweep.py at batches 128 and 1024 for "xla" and
        "pallas": its lines.
    Timings are printed, not gated.  Returns (launches, kernel rows)."""
    import contextlib
    import io
    import torch
    import torch.distributed as dist
    from bilevel_gait_gen_tpu_torch.mpc import bilevel
    from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod
    from bilevel_gait_gen_tpu_torch.parallel import multihost
    from bilevel_gait_gen_tpu_torch.sim import engine
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    t_phase = time.perf_counter()
    gait_case, loop_case = parallel_case(DEVICE)
    a = gait_case
    B = a["x0s"].shape[0]
    t0b = torch.zeros(B, device=DEVICE)
    xdb = a["x_des"].expand(B, -1).contiguous()
    (ref, ref_lanes), ref_ms = timed_ms(lambda: record_lane_objectives(
        lambda: bilevel.gait_opt_update(a["cfg"], a["params"], a["states"],
                                        a["x0s"], t0b, a["feets"], xdb)))
    ties = lane_ties(ref_lanes[0])

    # (b) a one-rank nccl group
    with multihost.one_rank_group(DEVICE):
        mesh = mesh_mod.make_mesh((1, 1), ("scenario", "alpha"),
                                  device=DEVICE)
        one, one_ms = timed_ms(mesh_mod.alpha_sharded_gait_opt_update(
            a["cfg"], a["params"], mesh), a["states"], a["x0s"], 0.0,
            a["feets"], a["x_des"])
        backend = dist.get_backend(mesh["alpha"].get_group())
        n_one = check_bitwise(tree_map(lambda x: x.to_local(), one), ref,
                              "alpha-sharded, one-rank group")
    print(f"[parallel] {card}; (b) one-rank {backend} group, bench width, "
          f"batch {B}: bit for bit the update without a group on all "
          f"{n_one} outputs; {one_ms:.0f} ms (without a group, lanes "
          f"recorded, {ref_ms:.0f} ms)", flush=True)

    # (c)'s references: the unsharded loop of 128, and of each rank's 64
    lp = loop_case

    def unsharded_loop(lo, hi):
        return engine.closed_loop(
            lp["model"], lp["params"], lp["cfg"], lp["wb_cfg"], lp["sim"],
            tree_map(lambda x: x[lo:hi], lp["states"]), lp["q0s"][lo:hi],
            lp["v0s"][lo:hi], lp["xds"][lo:hi], **PAR_LOOP)[1]

    ref_log, ref_loop_ms = timed_ms(unsharded_loop, 0,
                                    PAR_RANKS * PAR_LOOP_BATCH)
    part_logs, part_ms = zip(*(timed_ms(unsharded_loop, r * PAR_LOOP_BATCH,
                                        (r + 1) * PAR_LOOP_BATCH)
                               for r in range(PAR_RANKS)))

    # (a) and (c) in PAR_RANKS processes
    t_w = time.perf_counter()
    workers = run_parallel_workers(gait_case, loop_case)
    w_s = time.perf_counter() - t_w
    for w in workers[1:]:
        check_bitwise(w["res"], workers[0]["res"],
                      "alpha-sharded: the ranks' results")
    res = workers[0]["res"]
    sh_lanes = torch.cat([w["lanes"][0] for w in workers], dim=1)
    fin = torch.isfinite(ref_lanes[0]) & torch.isfinite(sh_lanes)
    lane_d = float(((sh_lanes - ref_lanes[0]).abs() / ref_lanes[0].abs()
                    .clamp_min(1.0))[fin].max()) if bool(fin.any()) else 0.0
    lane_eq = bool(torch.equal(sh_lanes.nan_to_num(), ref_lanes[0]
                               .nan_to_num()))
    verdict = check_alpha_sharded(res, ref, ties)
    check(finite_outputs(res.state.traj, res.grad_norm),
          "alpha-sharded: the plan finite")
    launches = {k: sum(w["launches"][k] for w in workers)
                for k in workers[0]["launches"]}
    krows = [r for w in workers for r in w["rows"]]
    for name in ("gtwg", "ipm_iter"):
        check(all(w["launches"][name] > 0 for w in workers),
              f"alpha-sharded: every rank launched {name}")
        check(any(r["kernel"] == name and r["shape"][0] == 2 * B
                  for r in krows),
              f"alpha-sharded: {name} held to its plain version at the "
              f"lanes' batch {2 * B}")
    # p = 16 equality rows: every sweep through ipm_iter_kernel
    check(all(w["by_kernel"] == {"ipm_iter_kernel": w["launches"]["ipm_iter"],
                                 "ipm_iter_handed_kernel": 0}
              for w in workers),
          f"alpha-sharded: every sweep through ipm_iter_kernel: "
          f"{[w['by_kernel'] for w in workers]}")
    ties_at = np.flatnonzero(ties).tolist()
    alpha_ne = np.flatnonzero(res.alpha.cpu().numpy()
                              != ref.alpha.cpu().numpy()).tolist()
    print(f"[parallel] (a) alpha-sharded gait update, {PAR_RANKS} gloo "
          f"processes on the card, mesh (1, {PAR_RANKS}), batch {B}, lanes "
          f"[{2 * B}, 256, 1280, p=16] a rank: {verdict}; float32 ties "
          f"(two best lanes within {TOL_PAR_TIE} relative) at {ties_at}, "
          f"alpha differs at {alpha_ne}; lane objectives "
          f"{'bit for bit' if lane_eq else f'max {lane_d:.3e} relative'} "
          f"from the unsharded; eager ms per rank "
          f"{[round(w['upd_ms'], 1) for w in workers]} (unsharded, lanes "
          f"recorded, {ref_ms:.1f}); launches {launches}; the processes "
          f"{w_s:.1f} s", flush=True)

    verdict = check_sharded_loop([w["loop"] for w in workers], ref_log,
                                 part_logs)
    print(f"[parallel] (c) scenario-sharded closed loop, {PAR_RANKS} x "
          f"{PAR_LOOP_BATCH} scenarios, {PAR_LOOP['n_ticks']} ticks, "
          f"mpc_every={PAR_LOOP['mpc_every']}: {verdict}; ms per rank and "
          f"run {[[round(x) for x in w['loop_ms']] for w in workers]} "
          f"(captures included), unsharded batch "
          f"{PAR_RANKS * PAR_LOOP_BATCH} {ref_loop_ms:.0f} ms, batch "
          f"{PAR_LOOP_BATCH} {[round(x) for x in part_ms]} ms", flush=True)

    # (d) the multihost demo
    demo = load_script("torch_multihost_demo")
    buf = io.StringIO()
    t_d = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = demo.main([])
    out = buf.getvalue()
    means = {ln.split("mean cost ")[1].split(",")[0]
             for ln in out.splitlines() if "mean cost" in ln}
    check(code == 0 and "MULTIHOST OK" in out and len(means) == 1
          and out.count("mean cost") == 2,
          f"torch_multihost_demo on the card:\n{out}")
    print(f"[parallel] (d) torch_multihost_demo: MULTIHOST OK, mean cost "
          f"{means.pop()} on both ranks; {time.perf_counter() - t_d:.1f} s",
          flush=True)

    # (e) distr_rejection's default
    dr = load_script("torch_distr_rejection")
    t_e = time.perf_counter()
    run = dr.plan(dr.setup(PAR_REJECTION_BATCH, DEVICE), DEVICE)
    nums = dr.report(run)
    check(finite_outputs(run["states2"].traj),
          "torch_distr_rejection: the plan finite")
    print(f"[parallel] (e) torch_distr_rejection batch "
          f"{PAR_REJECTION_BATCH}: first call "
          f"(capture included) {run['t_first'] * 1e3:.0f} ms, steady "
          f"{run['t_steady'] * 1e3:.1f} ms, solved {nums['solved']:.4f}; "
          f"{time.perf_counter() - t_e:.1f} s", flush=True)

    # (f) bench_sweep
    bs = load_script("torch_bench_sweep")
    t_f = time.perf_counter()
    pts = [bs.run(b, k, DEVICE) for k in PAR_SWEEP[1] for b in PAR_SWEEP[0]]
    print(f"[parallel] (f) torch_bench_sweep: "
          + "; ".join(f"{p['kernel']} {p['batch']}: {p['latency_ms']:.2f} "
                      f"ms, solved {p['solved']:.3f}" for p in pts)
          + f"; {time.perf_counter() - t_f:.1f} s", flush=True)
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, krows


def main() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need the card")
    check((REPO / "bilevel_gait_gen_tpu_torch").is_dir(),
          "run from a checkout of the repository")
    card = phase_device()
    phase_build()
    cfg = bench_config()
    rows = phase_kernels(cfg)
    launches, _, _ = phase_slice(cfg)
    phase_graphs(cfg)
    phase_card_vs_cpu(cfg)
    phase_rti_kernel(cfg)
    gj_launches, gj_forms = phase_cold_start_gj(cfg)
    loop_launches, loop_rows = phase_closed_loop(card)
    cent_launches, cent_rows, schur_rows, cent_ms = phase_centroidal(card)
    admm_ms = phase_admm(cfg)
    fam_launches, fam_rows, fam_ms = phase_families(card)
    hw_launches, hw_rows = phase_hardware(card)
    golden_launches, golden_rows = phase_golden(card)
    clh_launches, clh_rows = phase_closed_loop_harness(card)
    demo_launches, demo_rows = phase_demos(card)
    par_launches, par_rows = phase_parallel(card)
    # launches: gtwg and ipm_iter from the "chol" cadence (phase 4),
    # gj_inverse from the cold start + cycle under "gj" (phase 7), rgemm and
    # chol_inverse from the centroidal RTI (phase 9); every path's counts are
    # kept beside them
    rows += schur_rows
    for row in rows:
        name = row["name"]
        if name == "ipm_iter_handed_kernel":
            # the iteration kernel of the p > 32 sweeps: the centroidal RTI
            # is the one path with more than 32 equality rows
            row["launches"] = cent_launches[name]
            row["launches_by_path"] = {
                "centroidal_rti": cent_launches[name],
                "golden_rollout": 0,
                "closed_loop_harness": clh_launches[name],
                "demos": demo_launches[name],
                "alpha_sharded": par_launches[name]}
            row["golden_rollout_checks"] = []
            row["closed_loop_harness_checks"] = [
                r for r in clh_rows if r["kernel"] == name]
            row["demos_checks"] = [r for r in demo_rows
                                   if r["kernel"] == name]
            row["alpha_sharded_checks"] = [r for r in par_rows
                                           if r["kernel"] == name]
            continue
        path = (launches if name in launches else
                gj_launches if name in gj_launches else cent_launches)
        row["launches"] = path[name]
        row["launches_by_path"] = {"chol_cadence": launches.get(name, 0),
                                   "gj_cold_start": gj_launches.get(name, 0),
                                   "closed_loop": loop_launches[name],
                                   "centroidal_rti": cent_launches[name],
                                   "admm_block": 0,
                                   **{f"{fam}_cycle": n[name]
                                      for fam, n in fam_launches.items()},
                                   "hardware_loop": hw_launches[name],
                                   "golden_rollout": golden_launches[name],
                                   "closed_loop_harness": clh_launches[name],
                                   "demos": demo_launches[name],
                                   "alpha_sharded": par_launches[name]}
        row["closed_loop_checks"] = [r for r in loop_rows
                                     if r["kernel"] == name]
        row["centroidal_checks"] = [r for r in cent_rows
                                    if r["kernel"] == name]
        row["families_checks"] = [r for r in fam_rows if r["kernel"] == name]
        row["hardware_loop_checks"] = [r for r in hw_rows
                                       if r["kernel"] == name]
        row["golden_rollout_checks"] = [r for r in golden_rows
                                        if r["kernel"] == name]
        row["closed_loop_harness_checks"] = [r for r in clh_rows
                                             if r["kernel"] == name]
        row["demos_checks"] = [r for r in demo_rows if r["kernel"] == name]
        row["alpha_sharded_checks"] = [r for r in par_rows
                                       if r["kernel"] == name]
        if name == "gj_inverse":
            row["launches_by_form"] = gj_forms
    print(f"[paths] centroidal step ms {json.dumps(cent_ms)}; ADMM block ms "
          f"{json.dumps(admm_ms)}; families {json.dumps(fam_ms)}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
