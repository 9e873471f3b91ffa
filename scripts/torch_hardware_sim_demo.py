#!/usr/bin/env python3
"""End-to-end MPC-over-UDP demo on the PyTorch port: the full hardware
stack against a simulated robot (port of scripts/hardware_sim_demo.py;
reference hardware/hardware_interface.cpp driving the A1 over the Unitree
UDP link).  Both sides run in one process over loopback UDP with the wire
format of ``control/hardware``:

  controller side: ``control.hardware.HardwareRobot`` (the state
                   estimator's low-pass chains, the Stand-ramp state
                   machine, the torque check, the swing/stance gains)
                   whose control_fn is the port's MPC + whole-body QP;
  robot side:      MuJoCo physics playing the robot MCU: it streams state
                   packets, takes command packets and runs the motor PD law
                   tau = tau_ff + kp (q_des - q) + kd (dq_des - dq).

A mocap update (base position truth at 240 Hz) feeds the COM estimator.
The two endpoints bind ports the OS chose (``runtime.loopback_pair``).
The initial run, the RTI and the control tick run eagerly on the CPU; on
the card each is a CUDA graph captured at its first call and held there to
that call's eager result bit for bit.  Needs ``mujoco``; without ``--cpu``
the controller runs on the GPU, which must be there.

Usage: python scripts/torch_hardware_sim_demo.py [seconds] [--cpu] [--trot]
Exits 0 iff the robot is still upright at the end.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bilevel_gait_gen_tpu_torch import resolve_device, runtime  # noqa: E402
from bilevel_gait_gen_tpu_torch.control import hardware as hw  # noqa: E402
from bilevel_gait_gen_tpu_torch.control import (  # noqa: E402
    mpc_controller, wbqp)
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc import gait, solver  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (  # noqa: E402
    default_trajectory)
from bilevel_gait_gen_tpu_torch.sim.closed_loop import (  # noqa: E402
    settled_start)
from bilevel_gait_gen_tpu_torch.sim.mujoco_bridge import (  # noqa: E402
    MujocoLoop)
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.graphs import (  # noqa: E402
    FirstUseGraphs)


def make_config() -> MPCConfig:
    return MPCConfig(ipm_iters=18, double_support=0.1, force_carrier=True,
                     carrier_ramp=0.1).validate()


def setup(cfg, trot: bool, device, dtype=torch.float32):
    """hardware_sim_demo.py:57-71: (model, q0 settled [nq] as float64
    numpy, params, x0 [1, 13], feet0 [1, E, 3], the solver state [1],
    x_des [1, 12])."""
    model = a1.make_a1(device=device)
    q0_np = settled_start(model, np.asarray(a1.stand_config(), np.float64))
    q0 = torch.tensor(q0_np, dtype=dtype, device=device)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0, torch.zeros(
        model.nv, dtype=dtype, device=device))[None]
    feet0 = rbd.ee_positions(model, q0).to(dtype)[None]
    sched = (gait.make_trot(cfg, dtype=dtype, device=device) if trot
             else gait.make_standing(cfg, dtype=dtype, device=device))
    traj = default_trajectory(cfg, sched, x0, feet0[..., :2])
    state = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    return (model, q0_np, params, x0, feet0, state,
            srb.manifold_to_tangent(x0))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seconds = float(argv[0]) if argv and not argv[0].startswith("--") \
        else 2.0
    device = "cpu" if "--cpu" in argv else resolve_device(None)
    dtype = torch.float32
    cfg = make_config()
    wb_cfg = wbqp.WBQPConfig()
    model, q0_np, params, x0, feet0, state, x_des = setup(
        cfg, "--trot" in argv, device, dtype)
    nj = model.num_joints
    graphs = FirstUseGraphs(device)

    print("initial MPC run ...")
    state, stats = graphs("init_run", lambda st, x, ee: solver.
                          create_initial_run(cfg, params, st, x, ee, x_des),
                          state, x0, feet0)
    print(f"  solved={bool(stats.solved)}")

    def mpc_step(st, x, t, ee):
        return solver.solve_step(cfg, params, st, x, t, ee, x_des)

    def ctrl_full(tr, q, v, t, t0, mc):
        return mpc_controller.control_action_full(
            model, params, cfg, wb_cfg, tr, q, v, t, t0, mc)

    # ---- the UDP link (reference: Unitree SDK UDP at 2 kHz) --------------
    ctrl_ep, robot_ep = runtime.loopback_pair()

    loop = MujocoLoop(model, timestep=0.001)
    loop.set_state(q0_np, np.zeros(model.nv))

    def full(t):
        return torch.full((1,), t, dtype=dtype, device=device)

    holder = {"state": state, "t0": 0.0, "n_mpc": 0, "fails": 0,
              "q_full": np.asarray(q0_np, np.float32),
              "v_full": np.zeros(model.nv, np.float32),
              "contact": np.ones(cfg.num_ee, bool)}

    def control_fn(q_j, dq, quat, gyro, vcom, t, mode):
        """HardwareRobot's control callback: full q from IMU quat + mocap
        base, joints from the wire; runs the MPC at cfg.dt cadence."""
        base_p = holder["q_full"][0:3]
        qj = torch.tensor(np.concatenate([base_p, quat, q_j]), dtype=dtype,
                          device=device)[None]
        vj = torch.tensor(np.concatenate([vcom, gyro, dq]), dtype=dtype,
                          device=device)[None]
        mc = torch.tensor(holder["contact"], device=device)[None]
        if t >= holder["t0"] + cfg.dt or holder["n_mpc"] == 0:
            x_srb = srb.reconstruct_state(params, qj, vj)
            feet = rbd.ee_positions(model, qj)
            # early-touchdown schedule sync (AdjustForCurrentContacts)
            st_in = holder["state"]
            sched2 = gait.adjust_for_current_contacts(st_in.traj.sched, mc,
                                                      full(t))
            st_in = dataclasses.replace(
                st_in, traj=dataclasses.replace(st_in.traj, sched=sched2))
            st, stats = graphs("rti", mpc_step, st_in, x_srb, full(t), feet)
            holder["state"] = st
            holder["t0"] = t
            holder["n_mpc"] += 1
            if not bool(stats.solved):
                holder["fails"] += 1
        tau, q_des_j, dq_des_j, contact = graphs(
            "tick", ctrl_full, holder["state"].traj, qj, vj, full(t),
            full(holder["t0"]), mc)
        return (tau[0].cpu().numpy(), q_des_j[0].cpu().numpy(),
                dq_des_j[0].cpu().numpy(), contact[0].cpu().numpy())

    robot = hw.HardwareRobot(
        nj, ctrl_ep, control_fn,
        est_cfg=hw.EstimatorConfig(control_hz=1000.0),
        torque_limit=33.5,
        stand_config=np.asarray(q0_np[7:], np.float64))
    robot.set_mode(hw.Mode.MPC)

    n_steps = int(seconds * 1000)
    print(f"running {n_steps} ticks over loopback UDP ...")
    t_start = time.time()
    mj = loop._mujoco
    try:
        for k in range(n_steps):
            t = k * 0.001
            q_full, v_full = loop.get_state()
            holder["q_full"], holder["v_full"] = q_full, v_full
            holder["contact"] = loop.contacts()
            # mocap thread at 240 Hz (OptiTrackMonitor)
            if k % 4 == 0:
                robot.estimator.mocap_update(
                    np.asarray(q_full[0:3], np.float64), t)
            # robot MCU: stream the state packet
            robot_ep.send(hw.pack_state(
                k, np.asarray(q_full[7:], np.float64),
                np.asarray(v_full[6:], np.float64), np.zeros(nj),
                np.asarray(q_full[3:7], np.float64),
                np.asarray(v_full[3:6], np.float64), np.zeros(3)))
            # controller tick: recv -> estimate -> MPC/WBQP -> send command
            if not robot.step_once(t):
                continue
            # robot MCU: recv command, run the motor PD law, step physics
            pkt = None
            for _ in range(100):
                pkt = robot_ep.recv(4096)
                if pkt is not None:
                    break
                time.sleep(0.0002)
            if pkt is None:
                continue
            payload = np.frombuffer(pkt[8:], np.float32).reshape(nj, 5)
            q_des, dq_des, kp, kd, tau_ff = payload.T
            q_j = np.asarray(q_full[7:], np.float64)
            dq_j = np.asarray(v_full[6:], np.float64)
            tau_motor = tau_ff + kp * (q_des - q_j) + kd * (dq_des - dq_j)
            loop.mj_data.ctrl[:] = np.clip(tau_motor, -33.5, 33.5)
            mj.mj_step(loop.mj_model, loop.mj_data)
    finally:
        graphs.close()
    wall = time.time() - t_start

    q_full, _ = loop.get_state()
    z = float(q_full[2])
    z0 = float(q0_np[2])
    upright = z > 0.55 * z0
    print(f"wall {wall:.1f}s; MPC solves {holder['n_mpc']} "
          f"(fails {holder['fails']})")
    print(f"final z {z:.3f} (start {z0:.3f}) xy "
          f"{np.abs(np.asarray(q_full[:2])).max():.3f}")
    print("UPRIGHT" if upright else "FELL")
    return 0 if upright else 1


if __name__ == "__main__":
    raise SystemExit(main())
