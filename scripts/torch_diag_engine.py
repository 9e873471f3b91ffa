#!/usr/bin/env python3
"""On-device closed-loop telemetry probe on the PyTorch port: the big-cfg
trot with per-tick z / xy / torque / MPC-status traces (port of
scripts/diag_engine.py, the instrument behind the penalty-engine stability
forensics in docs/DESIGN.md).

Knobs via env vars: CONTACT_DAMP (WBQP foot-velocity damping), GAIN_SCALE
(torso PD scale), TORQUE_BOUND, CONTACT_KP/CONTACT_KD/TVREG/SUBSTEPS
(ground model), CONTROL_DT, MPC_EVERY, CONTACT_SYNC, DOUBLE_SUPPORT,
FORCE_CARRIER, CARRIER_RAMP, SWING_HEIGHT, RAIBERT; DIAG_CPU runs on the
CPU (otherwise the GPU, which must be there).  ``sim/engine.closed_loop``
runs eagerly on the CPU and as CUDA graphs on the card; the initial run is
captured on the card at its first call and held to its eager result.

Usage: [ENV=...] python scripts/torch_diag_engine.py [n_ticks]
"""
from __future__ import annotations

import os
import sys

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


def configure(env=os.environ) -> dict:
    """The probe's configuration from the environment (diag_engine.py:
    35-57): cfg, wb_cfg, sim, control_dt, mpc_every, contact_sync, damp."""
    cfg = MPCConfig(ipm_iters=18,
                    double_support=float(env.get("DOUBLE_SUPPORT", "0.15")),
                    force_carrier=bool(int(env.get("FORCE_CARRIER", "1"))),
                    carrier_ramp=float(env.get("CARRIER_RAMP", "0.15")),
                    swing_height=float(env.get("SWING_HEIGHT", "0.05")),
                    raibert=bool(int(env.get("RAIBERT", "0"))),
                    ).validate()
    damp = float(env.get("CONTACT_DAMP", "0"))
    gs = float(env.get("GAIN_SCALE", "1"))       # torso PD gain scale
    tb = float(env.get("TORQUE_BOUND", "30"))
    wb_cfg = wbqp.WBQPConfig(contact_damp=damp, torque_bound=tb,
                             kp_base_pos=9000.0 * gs, kd_base_pos=3000.0 * gs,
                             kp_base_ang=1000.0 * gs, kd_base_ang=100.0 * gs)
    sim = engine.SimConfig(substeps=int(env.get("SUBSTEPS", "4")),
                           contact_kp=float(env.get("CONTACT_KP", "12000")),
                           contact_kd=float(env.get("CONTACT_KD", "120")),
                           tangent_vel_reg=float(env.get("TVREG", "0.05")))
    return dict(cfg=cfg, wb_cfg=wb_cfg, sim=sim, damp=damp,
                control_dt=float(env.get("CONTROL_DT", "0.001")),
                mpc_every=int(env.get("MPC_EVERY", "50")),
                contact_sync=bool(int(env.get("CONTACT_SYNC", "1"))))


def setup(cfg, sim, device, dtype=torch.float32):
    """diag_engine.py:60-70 for one robot: (model, q0 [nq] settled at the
    static equilibrium, params, x0 [1, 13], feet0 [1, E, 3], the solver
    state [1] with its warm start, x_des [1, 12])."""
    model = a1.make_a1(device=device)
    # static-equilibrium settle: every foot at penetration mg/(E kp)
    q0 = engine.settled_stand(model, sim, torch.tensor(
        a1.stand_config(), dtype=dtype, device=device))
    params = srb.make_srb_params(model, q0)
    x0 = mpc_controller.reconstruct_srb_state(
        model, params, q0, torch.zeros(model.nv, dtype=dtype,
                                       device=device))[None]
    feet0 = rbd.ee_positions(model, q0).to(dtype)[None]
    traj = default_trajectory(cfg, gait.make_trot(cfg, dtype=dtype,
                                                  device=device),
                              x0, feet0[..., :2])
    # warm-started solver state: carries the IPM solution across ticks
    # (measured: 100% solved vs ~95% cold)
    st = solver.make_state(cfg, traj, torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    return model, q0, params, x0, feet0, st, srb.manifold_to_tangent(x0)


def probe(n_ticks: int, device, dtype=torch.float32, env=os.environ):
    """The probe: the initial run, ``n_ticks`` of the closed loop, and the
    JAX script's printed trace.  Returns (the final MPC state, SimLog
    [T, 1, ...])."""
    c = configure(env)
    cfg, sim = c["cfg"], c["sim"]
    print(f"damp={c['damp']} sim={sim}")
    model, q0, params, x0, feet0, st, x_des = setup(cfg, sim, device, dtype)
    graphs = FirstUseGraphs(device)
    try:
        st, stats = graphs("init_run", lambda s, x, e: solver.
                           create_initial_run(cfg, params, s, x, e, x_des),
                           st, x0, feet0)
        st, stats = tree_map(torch.clone, (st, stats))
    finally:
        graphs.close()
    print(f"initial: solved={bool(stats.solved)} "
          f"defect={float(stats.defect_l1):.2e}")

    st_out, log = engine.closed_loop(
        model, params, cfg, c["wb_cfg"], sim, st, q0[None],
        torch.zeros(1, model.nv, dtype=dtype, device=device), x_des,
        n_ticks=n_ticks, control_dt=c["control_dt"],
        mpc_every=c["mpc_every"], contact_sync=c["contact_sync"])

    control_dt, mpc_every = c["control_dt"], c["mpc_every"]
    q = log.q[:, 0].cpu().numpy()
    tau = log.tau[:, 0].cpu().numpy()
    solved = log.solved[:, 0].cpu().numpy()
    cost = log.cost[:, 0].cpu().numpy()
    mpc_ticks = np.arange(0, n_ticks, mpc_every)
    print("MPC ticks: solved =", solved[mpc_ticks].astype(int).tolist())
    print("cost      =", [f"{v:.0f}" for v in cost[mpc_ticks]])
    for k in range(0, n_ticks, 100):
        print(f"t={k*control_dt:.2f} z={q[k,2]:.3f} "
              f"xy=({q[k,0]:+.3f},{q[k,1]:+.3f})"
              f" |tau|max={np.abs(tau[k]).max():.1f}")
    print(f"final z={q[-1,2]:.3f}")
    return st_out, log


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_ticks = int(argv[0]) if argv else 1500
    device = "cpu" if os.environ.get("DIAG_CPU") else resolve_device(None)
    probe(n_ticks, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
