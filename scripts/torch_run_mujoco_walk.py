#!/usr/bin/env python3
"""Closed-loop trot in host MuJoCo with the PyTorch port's controller (port
of scripts/run_mujoco_walk.py; reference apps/mpc_sim_demo.cpp): MPC
real-time iterations at the MPC rate + whole-body QP torques at the control
rate, MuJoCo physics on the host.  The loop is the port's
``sim/closed_loop.run_closed_loop``; this script builds each robot's
configuration and judges the outcome.  The JAX script's comments give the
measurements behind every setting.

Needs ``mujoco`` (and ``matplotlib`` for the rollout plot).  Without
``--cpu`` the controller runs on the GPU, which must be there.

Usage: python scripts/torch_run_mujoco_walk.py [seconds] [--cpu] [--viewer]
       [--realtime] [--robot=adam|mini_cheetah] [--goal=X,Y] [--push[=v]]
       [--initpush[=v]] [--gait-opt[=freq]] [--stretch=S] [--raibert]
       [--gait=standing] [--config=push]
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bilevel_gait_gen_tpu_torch import resolve_device  # noqa: E402
from bilevel_gait_gen_tpu_torch.control import wbqp  # noqa: E402
from bilevel_gait_gen_tpu_torch.models import a1, rbd  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc import gait  # noqa: E402
from bilevel_gait_gen_tpu_torch.sim.closed_loop import (  # noqa: E402
    GoalCarrot, run_closed_loop, settled_start)
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig  # noqa: E402


def configure(argv, device, env=os.environ) -> dict:
    """run_mujoco_walk.py:37-202 before the run: the robot's model, cfg,
    wb_cfg, settled start q0 / v0, schedule, carrot, push, gait_opt_freq
    and stretch, as a dict."""
    dtype = torch.float32
    if "--config=push" in argv:
        # reference push-recovery config (a1_config_distr_rejection.yaml)
        cfg = MPCConfig(num_nodes=50, dt=0.02, ipm_iters=18,
                        force_bound=200.0, friction_coef=0.6,
                        force_cost=0.001,
                        contact_snap_window=float(env.get("SNAP", "0.25")),
                        q_diag=(140.0, 140.0, 12000.0, 0.015, 0.015, 10.0,
                                3000.0, 3000.0, 3000.0, 1.0, 1.0, 1.0)
                        ).validate()
    else:
        cfg = MPCConfig(ipm_iters=18,
                        contact_snap_window=float(env.get("SNAP", "0.25"))
                        ).validate()
    if "--raibert" in argv:
        # capture-point touchdown placement (reference
        # AddRaibertHeuristic): foothold = hip + T_st/2 v_com
        vg = env.get("RAIBERT_VGAIN", "1.0")
        vgt = (tuple(float(v) for v in vg.split(","))
               if "," in vg else float(vg))
        cfg = dataclasses.replace(cfg, raibert=True,
                                  raibert_vel_gain=vgt).validate()
    wb_cfg = wbqp.WBQPConfig()
    carrot_kw = dict(radius=0.25)
    adam = "--robot=adam" in argv

    if "--robot=mini_cheetah" in argv:
        from bilevel_gait_gen_tpu_torch.models import mini_cheetah as robot_mod
        model = robot_mod.make_mini_cheetah(device=device)
        q0_np = np.asarray(robot_mod.stand_config(), np.float64)
        cfg = dataclasses.replace(
            cfg, double_support=0.1, force_carrier=True,
            carrier_ramp=0.1).validate()
        wb_cfg = wbqp.WBQPConfig(torque_bound=float(model.effort_limit[0]),
                                 kp_joint=300.0, kd_joint=20.0)
    elif adam:
        # Adam biped (reference apps/adam_configuration.yaml)
        from bilevel_gait_gen_tpu_torch.models import adam as robot_mod
        model = robot_mod.make_adam(device=device)
        q0_np = np.asarray(robot_mod.stand_config(), np.float64)
        cfg = MPCConfig(num_ee=2, ipm_iters=18, friction_coef=0.3,
                        contact_snap_window=float(env.get("SNAP", "0.07")),
                        phase_duration=float(env.get("ADAM_PHASE", "0.3")),
                        force_bound=250.0, swing_height=0.08,
                        force_carrier=True,
                        double_support=float(env.get("ADAM_DSUP", "0.1")),
                        carrier_ramp=0.1, ee_box_size=(0.3, 0.3),
                        raibert=True,
                        raibert_vel_gain=tuple(
                            float(v) for v in env.get(
                                "ADAM_VGAIN", "2.5,1.0").split(",")),
                        raibert_hip_scale=tuple(
                            float(v) for v in env.get(
                                "ADAM_HSCALE", "0.0,1.0").split(",")),
                        q_diag=tuple(float(v) for v in env.get(
                            "ADAM_QDIAG",
                            "600,600,8000,8,8,10,6000,6000,6000,5,5,5"
                            ).split(",")),
                        ).validate()
        wb_cfg = wbqp.WBQPConfig(torque_bound=33.5, kp_joint=400.0,
                                 kd_joint=30.0, friction_coef=0.3,
                                 force_weight=5.0)
        carrot_kw = dict(radius=0.12, vel_carrot=True, v_walk=0.10,
                         ki=float(env.get("ADAM_KI", "0.5")),
                         stand_on_arrival=False)
    else:
        model = a1.make_a1(device=device)
        q0_np = np.asarray(a1.stand_config(), np.float64)
    if adam:
        # point feet: the support line must pass through the whole-body
        # COM or the robot topples in pitch from t=0.  Fixed-point IK:
        # feet x -> COM x.
        from bilevel_gait_gen_tpu_torch.control import ik as ik_mod
        qj = torch.tensor(q0_np, dtype=dtype, device=device)
        for _ in range(3):
            com = rbd.com_position(model, qj)
            feet = rbd.ee_positions(model, qj).clone()
            feet[:, 0] = com[0]
            qj = ik_mod.solve_ik(model, qj[0:3], qj[3:7], feet, qj,
                                 iters=20)
        q0_np = qj.cpu().numpy().astype(np.float64)
    # settle ALL feet into ground contact (a hovering pair destroys standing)
    q0_np = settled_start(model, q0_np)

    init_vx, push, goal, gait_opt_freq, stretch = 0.0, None, None, 0, 1.0
    for a in argv:
        if a.startswith("--initpush"):
            init_vx = float(a.split("=", 1)[1]) if "=" in a else 1.0
        elif a.startswith("--push"):
            # velocity impulse at t = 1 s (reference distr-rejection shape)
            push = (1.0, float(a.split("=", 1)[1]) if "=" in a else 1.0)
        elif a.startswith("--goal="):
            gx, gy = (float(v) for v in a.split("=", 1)[1].split(","))
            goal = (gx, gy)
        elif a.startswith("--gait-opt"):
            gait_opt_freq = int(a.split("=", 1)[1]) if "=" in a else 10
        elif a.startswith("--stretch="):
            # deliberately mistimed schedule: all phases stretched
            stretch = float(a.split("=", 1)[1])

    v0_np = np.zeros(model.nv)
    v0_np[0] = init_vx
    sched = (gait.make_standing(cfg, dtype=dtype, device=device)
             if "--gait=standing" in argv
             else gait.make_trot(cfg, dtype=dtype, device=device))
    if stretch != 1.0:
        sched = gait.GaitSchedule(bounds=sched.bounds * stretch)
    carrot = GoalCarrot(goal=goal, **carrot_kw) if goal is not None else None
    robot = ("adam" if adam else "mini_cheetah"
             if "--robot=mini_cheetah" in argv else "a1")
    return dict(model=model, cfg=cfg, wb_cfg=wb_cfg, q0=q0_np, v0=v0_np,
                sched=sched, carrot=carrot, push=push, goal=goal,
                gait_opt_freq=gait_opt_freq, stretch=stretch, robot=robot,
                dtype=dtype)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seconds = float(argv[0]) if argv and not argv[0].startswith("--") \
        else 2.0
    device = "cpu" if "--cpu" in argv else resolve_device(None)
    c = configure(argv, device)
    goal, push, gait_opt_freq = c["goal"], c["push"], c["gait_opt_freq"]
    adam = c["robot"] == "adam"

    print(f"closed loop: {seconds}s, robot={c['robot']}"
          + (f" goal={goal}" if goal else "")
          + (f" gait_opt_freq={gait_opt_freq}" if gait_opt_freq else "")
          + (f" stretch={c['stretch']}" if c["stretch"] != 1.0 else "")
          + (f" push={push}" if push else ""))
    t_start = time.time()
    res = run_closed_loop(
        c["model"], c["cfg"], c["wb_cfg"], c["q0"], c["v0"], seconds,
        sched=c["sched"], gait_opt_freq=gait_opt_freq, carrot=c["carrot"],
        push=push,
        # biped support exchanges pass through brief all-airborne
        # instants; the dwell filter keeps them out of the flight hold
        flight_dwell=0.025 if adam else 0.0,
        viewer="--viewer" in argv, realtime="--realtime" in argv,
        debug=bool(os.environ.get("WALK_DEBUG")), device=device,
        dtype=c["dtype"])
    wall = time.time() - t_start

    qs, z = res.qs, res.z
    print(f"wall {wall:.1f}s for {seconds}s sim")
    print(f"MPC solves: {res.n_mpc} (avg {res.mpc_ms:.1f} ms) "
          f"fails: {res.n_fails}"
          + (f" gait accepts: {res.n_gait_accepts}" if gait_opt_freq else ""))
    print(f"ctrl ticks avg {res.ctrl_ms:.2f} ms")
    print(f"z: start {z[0]:.3f} min {z.min():.3f} max {z.max():.3f} "
          f"end {z[-1]:.3f}")
    print(f"xy drift: {np.abs(qs[:, 0:2]).max(axis=0)}")
    upright = z.min() > 0.55 * z[0]
    if goal is not None:
        err_t = np.hypot(qs[:, 0] - goal[0], qs[:, 1] - goal[1])
        err = float(err_t[-1])
        err_min = float(err_t.min())
        print(f"goal {goal}: final ({qs[-1,0]:+.3f},{qs[-1,1]:+.3f}) "
              f"err {err:.3f} m (min over run {err_min:.3f} at "
              f"t={err_t.argmin()/1000:.1f}s)"
              + (f"  arrived->stand at t={res.arrived_t:.1f}s"
                 if res.arrived_t >= 0 else ""))
        if adam:
            # biped criterion: reach the goal and hold station
            upright = upright and err_min < 0.18 and err < 0.30
        else:
            upright = upright and err < 0.15
    if gait_opt_freq:
        k = max(len(res.costs) // 5, 1)
        print(f"planning cost: first-5th {np.mean(res.costs[:k]):+.0f} "
              f"last-5th {np.mean(res.costs[-k:]):+.0f}")
    print("WALKED" if upright else "FELL")
    np.save(os.path.join(tempfile.gettempdir(), "walk_qs.npy"), qs)
    from bilevel_gait_gen_tpu_torch.sim import viz
    # the logged MuJoCo qpos rows (wxyz) in the port's convention (xyzw)
    qs_c = qs.copy()
    qs_c[:, 3:7] = qs[:, [4, 5, 6, 3]]
    p = viz.plot_rollout(qs_c, path=os.path.join(tempfile.gettempdir(),
                                                 "walk_rollout.png"))
    print(f"rollout plot: {p}")
    return 0 if upright else 1


if __name__ == "__main__":
    raise SystemExit(main())
