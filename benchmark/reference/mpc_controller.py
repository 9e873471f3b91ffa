"""MPC controller: the MPC trajectory to whole-body torques, batch first
(port of ``bilevel_gait_gen_tpu/control/mpc_controller.py``).

* :func:`reconstruct_srb_state`: (q, v) -> SRB manifold state;
* :func:`targets_from_traj`: the MPC trajectory interpolated at time t
  (:func:`ik_targets`), IK for the desired configuration, spline foot
  velocities and force targets (:func:`feet_motion`);
* :func:`control_action`: the 1 kHz step, targets, the base's velocity
  (:func:`base_velocity`) and the IK's velocities, then the whole-body QP's
  torques (:func:`control_action_full` also returns the motor targets),
  each stage run through a hook (:func:`plain_call`).

Every function takes B scenarios: q [B, nq], v [B, nv], t and t0 [B], the
trajectory batch first.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import ik as ik_mod
from . import wbqp
from . import srb
from .rbd import RobotModel
from . import gait as gait_mod
from .trajectory import Trajectory
from . import quat as quat_ops
from . import spline
from .pdip import spd_solve
from . import jnp_compat as jc
from .config import MPCConfig


def reconstruct_srb_state(model: RobotModel, params: srb.SRBParams,
                          q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """SRB manifold state [..., 13] from the full robot (q, v)."""
    return srb.reconstruct_state(params, q, v)


def interpolate_state(traj: Trajectory, t: torch.Tensor, t0: torch.Tensor,
                      dt: float) -> torch.Tensor:
    """[B, 13] linear interpolation of the manifold states between nodes
    at t [B] (window start t0 [B]), the quaternion renormalized."""
    N = traj.x_man.shape[-2] - 1
    s = torch.clamp((t - t0) / dt, 0.0, N - 1e-6)
    k = torch.floor(s).to(torch.int64)
    a = (s - k.to(s.dtype))[..., None]
    x0 = jc.take(traj.x_man, k, -2)
    x1 = jc.take(traj.x_man, torch.clamp_max(k + 1, N), -2)
    x = (1 - a) * x0 + a * x1
    return torch.cat([x[..., 0:6], quat_ops.normalize(x[..., 6:10]),
                      x[..., 10:]], dim=-1)


def ik_targets(cfg: MPCConfig, traj: Trajectory, t: torch.Tensor,
               t0: torch.Tensor, com_offset: torch.Tensor | None = None):
    """What the IK of :func:`targets_from_traj` tracks: (x [B, 13], the
    feet's targets [B, E, 3], the base position [B, 3])."""
    x = interpolate_state(traj, t, t0, cfg.dt)
    feet = spline.foot_positions_all(traj.sched.bounds, traj.footholds, t,
                                     cfg.swing_height, cfg.foot_offset)
    base_pos = x[..., 0:3]
    if com_offset is not None:
        R = quat_ops.to_matrix(quat_ops.normalize(x[..., 6:10]))
        base_pos = base_pos - (R @ com_offset[:, None])[..., 0]
    return x, feet, base_pos


def feet_motion(model: RobotModel, cfg: MPCConfig, traj: Trajectory,
                t: torch.Tensor, feet: torch.Tensor):
    """The rest of :func:`targets_from_traj` after its IK: (feet_vel
    [B, E, 3], f_des [B, E, 3], contact [B, E])."""
    bounds = traj.sched.bounds
    # foot velocities from the spline (finite difference of the pure eval)
    eps = 1e-4
    feet2 = spline.foot_positions_all(bounds, traj.footholds, t + eps,
                                      cfg.swing_height, cfg.foot_offset)
    feet_vel = (feet2 - feet) / eps
    contact = gait_mod.contact_flags(traj.sched, t)
    f_des = spline.forces_all(bounds, traj.f_nodes, t, cfg.num_force_polys)
    if cfg.force_carrier:
        f_des = f_des + spline.carrier_forces(
            bounds, t, model.total_mass * 9.81, cfg.carrier_ramp)
    f_des = f_des * contact[..., None]
    return feet_vel, f_des, contact


def targets_from_traj(model: RobotModel, cfg: MPCConfig, traj: Trajectory,
                      t: torch.Tensor, t0: torch.Tensor,
                      q_guess: torch.Tensor,
                      com_offset: torch.Tensor | None = None):
    """(x [B, 13], q_des [B, nq], feet_vel [B, E, 3], f_des [B, E, 3],
    contact [B, E]) at time t from the MPC solution.  com_offset: the
    body-frame base -> COM offset (the plan's p is the COM; the IK pins the
    base origin)."""
    x, feet, base_pos = ik_targets(cfg, traj, t, t0, com_offset)
    q_des = ik_mod.solve_ik(model, base_pos, x[..., 6:10], feet, q_guess)
    feet_vel, f_des, contact = feet_motion(model, cfg, traj, t, feet)
    return x, q_des, feet_vel, f_des, contact


def base_velocity(params: srb.SRBParams, x: torch.Tensor):
    """The base twist that the plan's state x [B, 13] implies: (world
    linear velocity [B, 3], body angular velocity [B, 3])."""
    R = quat_ops.to_matrix(x[..., 6:10])
    omega_body = spd_solve(params.inertia, jc.matvec(R.mT, x[..., 10:13]))
    # the plan's h is the COM momentum; base velocity = v_com - w x (R c)
    v_com = x[..., 3:6] / params.mass
    base_vel = v_com - torch.linalg.cross(jc.matvec(R, omega_body),
                                          jc.matvec(R, params.com_offset))
    return base_vel, omega_body


def plain_call(name: str, fn: Callable, *args):
    """The stage hook of :func:`control_action_full` and of
    ``sim/engine.period``: each stage runs as ``call(name, fn, *args)``,
    which may record or replace its inputs and outputs
    (``sim/batch_invariance``); this one just runs it."""
    return fn(*args)


def control_action_full(model: RobotModel, params: srb.SRBParams,
                        cfg: MPCConfig, wb_cfg: wbqp.WBQPConfig,
                        traj: Trajectory, q: torch.Tensor, v: torch.Tensor,
                        t: torch.Tensor, t0: torch.Tensor,
                        measured_contact: torch.Tensor | None = None, *,
                        call: Callable = plain_call):
    """One low-level control tick with its motor targets: (tau [B, nj],
    q_des joints [B, nj], dq_des joints [B, nj], contact [B, E]).

    measured_contact [B, E] bool: the stationary-contact rows apply only to
    feet that are both scheduled and measured in contact.  ``call``: the
    stage hook (:func:`plain_call`); the stages are the targets, the IK,
    the feet's motion, the base's velocity, the IK's velocities and the
    torque QP (which also returns its sweeps)."""
    x, feet, base_pos = call("targets", lambda tr, t, t0: ik_targets(
        cfg, tr, t, t0, params.com_offset), traj, t, t0)
    q_des = call("ik", lambda bp, x, f, q: ik_mod.solve_ik(
        model, bp, x[..., 6:10], f, q), base_pos, x, feet, q)
    feet_vel, f_des, contact = call("feet_motion", lambda tr, t, f:
                                    feet_motion(model, cfg, tr, t, f),
                                    traj, t, feet)
    if measured_contact is not None:
        contact = contact & measured_contact
    f_des = f_des * contact[..., None]
    base_vel, omega_body = call("base_velocity", lambda x: base_velocity(
        params, x), x)
    v_des = call("ik_velocities", lambda qd, bv, w, fv: ik_mod.ik_velocities(
        model, qd, bv, w, fv), q_des, base_vel, omega_body, feet_vel)
    tau, _ = call("wbqp", lambda q, v, c, qd, vd, fd: wbqp.torques_and_sweeps(
        model, wb_cfg, q, v, c, qd, vd, fd), q, v, contact, q_des, v_des,
        f_des)
    return tau, q_des[..., 7:], v_des[..., 6:], contact


def control_action(model: RobotModel, params: srb.SRBParams, cfg: MPCConfig,
                   wb_cfg: wbqp.WBQPConfig, traj: Trajectory, q: torch.Tensor,
                   v: torch.Tensor, t: torch.Tensor, t0: torch.Tensor,
                   measured_contact: torch.Tensor | None = None, *,
                   call: Callable = plain_call) -> torch.Tensor:
    """One low-level control tick -> joint torques [B, nj]."""
    return control_action_full(model, params, cfg, wb_cfg, traj, q, v, t, t0,
                               measured_contact, call=call)[0]
