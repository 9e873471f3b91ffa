#!/usr/bin/env python3
"""Batched closed-loop simulation on the PyTorch port: N robots in parallel
(port of scripts/batch_sim_demo.py, whose docstring gives the status and
the physics caveats of the penalty-ground engine).

The whole closed loop (penalty-contact physics, the whole-body QP at the
control rate, MPC real-time iterations) runs batch first through
``sim/engine.closed_loop``: eagerly on CPU tensors, and on the card as one
CUDA graph per kind of MPC period (a trailing partial period is a kind of
its own), replayed.  Each call of ``closed_loop`` captures its graphs
anew, so on the card the second, "steady" run includes its captures as
the first does (the JAX script's second call reuses its compiled program).

The joint perturbations are drawn from a ``torch.Generator`` seeded 0 where
the JAX script uses ``PRNGKey(0)``: the same distribution, other draws.

Usage: python scripts/torch_batch_sim_demo.py [batch] [ticks] [--cpu]
       [--pert=0.01] [--trot] [--big]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bilevel_gait_gen_tpu_torch import resolve_device  # noqa: E402
from bilevel_gait_gen_tpu_torch.control import (  # noqa: E402
    mpc_controller, wbqp)
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc import gait, solver  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (  # noqa: E402
    default_trajectory)
from bilevel_gait_gen_tpu_torch.sim import engine  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.graphs import (  # noqa: E402
    FirstUseGraphs, tree_map)


def configure(argv):
    """The run's options from the command line (batch_sim_demo.py:45-78):
    a dict of B, n_ticks, cfg, wb_cfg, sim, control_dt, mpc_every, trot and
    pert."""
    args = [a for a in argv if not a.startswith("--")]
    run = dict(B=int(args[0]) if args else 16,
               n_ticks=int(args[1]) if len(args) > 1 else 100,
               trot="--trot" in argv, pert=0.01)
    if "--big" in argv:
        # the regime validated to walk in MuJoCo (run_mujoco_walk.py):
        # full N=20 horizon, 1 kHz low level, 20 Hz MPC
        run.update(control_dt=0.001, mpc_every=50,
                   cfg=MPCConfig(ipm_iters=18).validate(),
                   wb_cfg=wbqp.WBQPConfig(),
                   sim=engine.SimConfig(substeps=1))
    else:
        if run["trot"]:
            cfg = MPCConfig(num_nodes=12, num_phase_slots=8,
                            samples_per_stance=6,
                            ipm_iters=12, max_ls_iters=6).validate()
        else:
            # the closed-loop-standing regime of
            # tests/test_sim_engine.py::test_closed_loop_standing_small;
            # spline forces are structurally zero at every phase boundary
            # (first at 2*phase_duration = 1 s), so standing runs stay
            # inside one stance phase
            cfg = MPCConfig(num_nodes=6, num_phase_slots=4,
                            phase_duration=0.5, samples_per_stance=4,
                            ee_node_start=1, ipm_iters=15, init_run_iters=3,
                            max_ls_iters=4).validate()
        run.update(control_dt=0.004,     # 250 Hz low level
                   mpc_every=12,         # ~20 Hz MPC
                   cfg=cfg, wb_cfg=wbqp.WBQPConfig(ipm_iters=12),
                   sim=engine.SimConfig(substeps=2))
    for a in argv:
        if a.startswith("--pert="):
            run["pert"] = float(a.split("=")[1])
    return run


def setup(cfg, sim, trot: bool, device, dtype=torch.float32):
    """batch_sim_demo.py:80-100 for one robot: (model, q0 [nq], params, x0
    [1, 13], feet0 [1, E, 3], the solver state [1], x_des [1, 12]); q0 is
    the stand lowered onto the penalty springs' force equilibrium."""
    model = a1.make_a1(device=device)
    q0_np = np.asarray(a1.stand_config(), np.float64)
    feet_z0 = rbd.ee_positions(model, torch.tensor(q0_np, dtype=dtype,
                                                   device=device))[:, 2]
    # settle at penalty-spring force equilibrium (pen = mg / (4 kp)): the
    # springs must carry the robot at t=0 or the kd_base term turns the
    # settle transient into railed torques and a hop-sag limit cycle
    pen_eq = float(model.total_mass) * 9.81 / (4 * sim.contact_kp)
    q0_np[2] -= float(torch.max(feet_z0)) - sim.foot_radius + pen_eq
    q0 = torch.tensor(q0_np, dtype=dtype, device=device)
    params = srb.make_srb_params(model, q0)
    x0 = mpc_controller.reconstruct_srb_state(
        model, params, q0, torch.zeros(model.nv, dtype=dtype,
                                       device=device))[None]
    feet0 = rbd.ee_positions(model, q0).to(dtype)[None]
    sched = (gait.make_trot(cfg, dtype=dtype, device=device) if trot
             else gait.make_standing(cfg, dtype=dtype, device=device))
    traj = default_trajectory(cfg, sched, x0, feet0[..., :2])
    st = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    return model, q0, params, x0, feet0, st, srb.manifold_to_tangent(x0)


def prepare(argv, device, dtype=torch.float32) -> dict:
    """The run's options, the initial run (printed) and the batch: B copies
    of the solved state, the stand with seeded joint perturbations, zero
    velocities; the arguments of ``engine.closed_loop`` under "loop"."""
    run = configure(argv)
    cfg, B = run["cfg"], run["B"]
    model, q0, params, x0, feet0, st, x_des = setup(
        cfg, run["sim"], run["trot"], device, dtype)
    graphs = FirstUseGraphs(device)
    try:
        st, stats = graphs("init_run", lambda s, x, e: solver.
                           create_initial_run(cfg, params, s, x, e, x_des),
                           st, x0, feet0)
        st, stats = tree_map(torch.clone, (st, stats))
    finally:
        graphs.close()
    print(f"initial run: solved={bool(stats.solved)} "
          f"defect={float(stats.defect_l1):.2e}")

    # batch: randomized initial joint perturbations (domain-randomization
    # style robustness sweep)
    gen = torch.Generator().manual_seed(0)
    dq = run["pert"] * torch.randn((B, model.num_joints), generator=gen,
                                   dtype=dtype)
    q0s = q0[None].repeat(B, 1)
    q0s[:, 7:] += dq.to(device)
    run["loop"] = dict(
        model=model, params=params, cfg=cfg, wb_cfg=run["wb_cfg"],
        sim=run["sim"], state0=tree_map(lambda a: a.repeat_interleave(B, 0),
                                        st),
        q0=q0s, v0=torch.zeros(B, model.nv, dtype=dtype, device=device),
        x_des_tan=x_des.repeat(B, 1), n_ticks=run["n_ticks"],
        control_dt=run["control_dt"], mpc_every=run["mpc_every"])
    return run


def simulate(run: dict):
    """``engine.closed_loop`` on the prepared batch, waited for: (final
    state, SimLog [T, B, ...])."""
    out = engine.closed_loop(**run["loop"])
    if out[1].q.is_cuda:
        torch.cuda.synchronize()
    return out


def report(run: dict, log, t_compile: float, t_run: float) -> dict:
    """batch_sim_demo.py:129-136's lines; returns its numbers."""
    B, n_ticks = run["B"], run["n_ticks"]
    z = log.q[:, :, 2].T.cpu().numpy()                  # [B, T]
    upright = (z.min(axis=1) > 0.15)
    sim_s = n_ticks * run["control_dt"]
    print(f"{B} robots x {sim_s:.2f} s sim: compile+run {t_compile:.1f} s, "
          f"steady {t_run:.2f} s "
          f"({B * sim_s / t_run:.1f}x realtime aggregate)")
    print(f"upright: {upright.sum()}/{B}  z final mean "
          f"{z[:, -1].mean():.3f}  min {z.min():.3f}")
    return dict(upright=int(upright.sum()), realtime=B * sim_s / t_run,
                z_min=float(z.min()), z_final_mean=float(z[:, -1].mean()))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else resolve_device(None)
    run = prepare(argv, device)
    t0 = time.time()
    simulate(run)
    t_compile = time.time() - t0
    t0 = time.perf_counter()
    _, log = simulate(run)
    t_run = time.perf_counter() - t0
    report(run, log, t_compile, t_run)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
