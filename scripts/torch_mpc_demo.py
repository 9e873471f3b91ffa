#!/usr/bin/env python3
"""Open-loop MPC + gait-optimization demo on the PyTorch port (port of
scripts/mpc_demo.py; reference apps/mpc_demo.cpp): run the initial SQP, a
stretch of real-time iterations fed back on the plan, and a bilevel gait
update; export a plan plot.

Usage: python scripts/torch_mpc_demo.py [--cpu] [--gait-opt]

Without ``--cpu`` it runs on the GPU and raises when there is none.  Where
the JAX script jits a function (the initial run, the RTI, the gait update)
the port captures it on the card as a CUDA graph at its first call, held
there to that call's eager result bit for bit, and runs it eagerly on the
CPU.  :func:`solve` is the solve part (no plot), :func:`main` adds the plot.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import NamedTuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from bilevel_gait_gen_tpu_torch import resolve_device  # noqa: E402
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc import bilevel, gait, solver  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (  # noqa: E402
    default_trajectory)
from bilevel_gait_gen_tpu_torch.ops import spline  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.graphs import (  # noqa: E402
    FirstUseGraphs, tree_map)
from bilevel_gait_gen_tpu_torch.utils.stats import (  # noqa: E402
    make_ring, print_table, record)

N_ITERS = 20


class Setup(NamedTuple):
    """The demo's start for one robot, batch first: the A1 standing, a trot
    from t = 0, a solver state without warm start."""
    model: object
    q0: torch.Tensor         # [nq]
    params: srb.SRBParams
    x0: torch.Tensor         # [1, 13]
    feet0: torch.Tensor      # [1, E, 3]
    state: solver.SolverState
    x_des: torch.Tensor      # [1, 12]


class DemoRun(NamedTuple):
    state: solver.SolverState   # the final plan (after the gait update)
    init_stats: solver.SolveStats
    stats: solver.SolveStats    # the last RTI's
    ring: object                # utils/stats ring of the RTIs
    rti_ms: list                # wall ms of each RTI
    gait: object                # GaitOptResult, or None
    gait_s: float               # the gait update's wall s, first call
    graphs: FirstUseGraphs      # closed: counts and times only


def setup(cfg: MPCConfig, device, dtype=torch.float32) -> Setup:
    """mpc_demo.py:31-40 on ``device`` in ``dtype``."""
    model = a1.make_a1(device=device)
    q0 = torch.tensor(a1.stand_config(), dtype=dtype, device=device)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0, torch.zeros_like(q0[1:]))[None]
    feet0 = rbd.ee_positions(model, q0).to(dtype)[None]
    traj = default_trajectory(cfg, gait.make_trot(cfg, dtype=dtype,
                                                  device=device),
                              x0, feet0[..., :2])
    state = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    return Setup(model, q0, params, x0, feet0, state,
                 srb.manifold_to_tangent(x0))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solve(cfg: MPCConfig, n_iters: int, gait_opt: bool, device,
          dtype=torch.float32) -> DemoRun:
    """mpc_demo.py:42-80 without the plot: the initial run, ``n_iters``
    RTIs each fed the plan's own next node and feet, recorded in a stats
    ring (printed), and with ``gait_opt`` one bilevel gait update.  Prints
    the JAX script's lines."""
    s = setup(cfg, device, dtype)
    params, x_des = s.params, s.x_des
    graphs = FirstUseGraphs(device)
    try:
        print("CreateInitialRun ...")
        state, stats = graphs(
            "init_run", lambda st, x, e: solver.create_initial_run(
                cfg, params, st, x, e, x_des), s.state, s.x0, s.feet0)
        init_stats = stats
        print(f"  solved={bool(stats.solved)} "
              f"defect={float(stats.defect_l1):.2e} "
              f"cost={float(stats.cost):.2f}")

        def step(st, x, t, ee):
            return solver.solve_step(cfg, params, st, x, t, ee, x_des)

        ring = make_ring(dtype=dtype, device=device)
        rti_ms = []
        for k in range(1, n_iters + 1):
            t0 = torch.full((1,), cfg.dt * k, dtype=dtype, device=device)
            x_cur = state.traj.x_man[:, 1]
            feet = spline.foot_positions_all(
                state.traj.sched.bounds, state.traj.footholds, t0,
                cfg.swing_height, cfg.foot_offset)
            tm = time.perf_counter()
            state, stats = graphs("rti", step, state, x_cur, t0, feet)
            _sync(device)
            rti_ms.append((time.perf_counter() - tm) * 1e3)
            ring = record(ring, k, rti_ms[-1], stats)
        print(f"{n_iters} real-time iterations, avg "
              f"{sum(rti_ms) / n_iters:.1f} ms")
        print_table(ring, last=10)

        res, gait_s = None, 0.0
        if gait_opt:
            print("bilevel gait update ...")
            tm = time.perf_counter()
            res = graphs(
                "gait", lambda st, x, t, ee: bilevel.gait_opt_update(
                    cfg, params, st, x, t, ee, x_des),
                state, state.traj.x_man[:, 0],
                torch.full((1,), cfg.dt * n_iters, dtype=dtype,
                           device=device), feet)
            _sync(device)
            gait_s = time.perf_counter() - tm
            print(f"  alpha={float(res.alpha):.2f} cost={float(res.cost):.2f} "
                  f"|grad|={float(res.grad_norm):.3f} "
                  f"({gait_s:.1f}s incl compile)")
            state = res.state
        # the results outlive the graphs whose buffers hold them
        out = tree_map(torch.clone, (state, init_stats, stats, res))
    finally:
        graphs.close()
    return DemoRun(out[0], out[1], out[2], ring, rti_ms, out[3], gait_s,
                   graphs)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else resolve_device(None)
    cfg = MPCConfig(ipm_iters=18).validate()
    run = solve(cfg, N_ITERS, "--gait-opt" in argv, device)

    from bilevel_gait_gen_tpu_torch.sim import viz
    path = viz.plot_plan(run.state.traj, cfg, t0=float(cfg.dt * N_ITERS),
                         path=os.path.join(tempfile.gettempdir(),
                                           "mpc_plan.png"))
    print("plan plot:", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
