"""On-device closed-loop simulation, batch first (port of
``bilevel_gait_gen_tpu/sim/engine.py``): articulated dynamics on a penalty
ground, the 1 kHz whole-body torque QP, MPC real-time iterations and the
bilevel gait update on its cadence.

The JAX package runs the loop as one ``lax.scan`` over ticks, with
``lax.cond`` on the tick index for the MPC update and for the gait update
in place of an RTI.  Here the loop is a Python loop over MPC periods, and
one period (:func:`period`: the MPC update on its first tick, then
``mpc_every`` control ticks with their physics substeps) is a plain function
of a :class:`LoopState`.  The choice of update is a Python branch on the
period's index, so a batch pays the gait update on its tick only (under
``vmap`` the reference pays it on every MPC tick; the results are the
same).  :func:`closed_loop` runs the periods eagerly on the CPU; on the
card it captures one CUDA graph of an RTI period and one of a gait period
(``utils/graphs.Graphed``) and replays them, the state chained through the
graphs' carry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from . import ik as ik_mod
from . import mpc_controller, wbqp
from .mpc_controller import plain_call
from . import rbd, srb
from .rbd import RobotModel
from . import bilevel as bilevel_mod
from . import gait as gait_mod
from . import solver as solver_mod
from .pdip import spd_solve
from . import jnp_compat as jc
from .config import MPCConfig
from .consts import const


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Penalty contact model and integration parameters (the port's own
    copy of the JAX package's ``SimConfig``; the contact latch's hysteresis
    is explained there)."""
    contact_kp: float = 12000.0
    contact_kd: float = 120.0
    friction_mu: float = 0.6
    tangent_vel_reg: float = 0.05
    foot_radius: float = 0.02
    substeps: int = 4
    joint_damping: float = 0.1
    contact_enter_margin: float = 0.001
    contact_exit_margin: float = 0.006


def settled_stand(model: RobotModel, sim: SimConfig,
                  q_nominal: torch.Tensor) -> torch.Tensor:
    """Static-equilibrium standing configuration(s) [..., nq] on the penalty
    ground: IK puts every foot at the same penetration m g / (E kp), so the
    ground carries the weight at t = 0."""
    feet = rbd.ee_positions(model, q_nominal)
    E = feet.shape[-2]
    pen = model.total_mass * 9.81 / (E * sim.contact_kp)
    z_target = (sim.foot_radius - pen).to(feet.dtype)
    feet_t = torch.cat([feet[..., :2], z_target.expand(feet.shape[:-1])[
        ..., None]], dim=-1)
    dz = torch.mean(feet[..., 2], dim=-1) - z_target
    base_pos = torch.cat([q_nominal[..., 0:2],
                          (q_nominal[..., 2] - dz)[..., None]], dim=-1)
    return ik_mod.solve_ik(model, base_pos, q_nominal[..., 3:7], feet_t,
                           q_nominal, iters=30)


def contact_forces(sim: SimConfig, feet: torch.Tensor,
                   feet_vel: torch.Tensor) -> torch.Tensor:
    """[..., E, 3] penalty ground forces at the foot points (flat ground
    z = 0)."""
    pen = sim.foot_radius - feet[..., 2]              # > 0 when penetrating
    fz = torch.where(pen > 0.0,
                     sim.contact_kp * pen
                     - sim.contact_kd * feet_vel[..., 2] * torch.sqrt(
                         torch.clamp_min(pen, 0.0) / sim.foot_radius),
                     0.0)
    fz = torch.clamp_min(fz, 0.0)
    vt = feet_vel[..., :2]
    vnorm = torch.sqrt(torch.sum(vt * vt, dim=-1) + sim.tangent_vel_reg ** 2)
    ft = -vt * (sim.friction_mu * fz / vnorm)[..., None]
    return torch.cat([ft, fz[..., None]], dim=-1)


def physics_step(model: RobotModel, sim: SimConfig, q: torch.Tensor,
                 v: torch.Tensor, tau: torch.Tensor, dt: float):
    """One semi-implicit Euler step of the articulated dynamics:
    (q [..., nq], v [..., nv])."""
    M, h, J, feet, _ = rbd.dynamics_terms(model, q, v)
    feet_vel = (J @ v[..., None, :, None])[..., 0]
    f_c = contact_forces(sim, feet, feet_vel)
    tau_full = torch.cat([torch.zeros_like(v[..., :6]), tau], dim=-1)
    damping = const((0.0,) * 6 + (sim.joint_damping,) * model.num_joints,
                    v.dtype, v.device)
    E = J.shape[-3]
    rhs = (tau_full - h - damping * v
           + jc.vecmat(f_c.flatten(-2), J.reshape(*J.shape[:-3], 3 * E, -1)))
    qdd = spd_solve(M, rhs)
    v_new = v + dt * qdd
    return rbd.integrate_config(q, dt * v_new), v_new


class SimLog(NamedTuple):
    q: torch.Tensor          # [T, B, nq]
    v: torch.Tensor          # [T, B, nv]
    srb_state: torch.Tensor  # [T, B, 13]
    tau: torch.Tensor        # [T, B, nj]
    cost: torch.Tensor       # [T, B], NaN on ticks without an MPC update
    solved: torch.Tensor     # [T, B], True on ticks without an MPC update


@dataclasses.dataclass(frozen=True)
class LoopState:
    """What the closed loop carries from tick to tick (the JAX scan's carry
    plus the tick index, which the graphs need as a tensor)."""
    q: torch.Tensor                  # [B, nq]
    v: torch.Tensor                  # [B, nv]
    st: solver_mod.SolverState       # the MPC state, batch first
    t0: torch.Tensor                 # [B] time of the last MPC update
    mc: torch.Tensor                 # [B, E] latched measured contact
    trust: torch.Tensor              # [B] the gait update's trust radius
    tick: torch.Tensor               # [] int64 index of the next tick


def initial_state(model: RobotModel, cfg: MPCConfig, sim: SimConfig,
                  state0: solver_mod.SolverState, q0: torch.Tensor,
                  v0: torch.Tensor) -> LoopState:
    """The loop's state before tick 0."""
    B, dtype, dev = q0.shape[0], q0.dtype, q0.device
    mc0 = rbd.ee_positions(model, q0)[..., 2] < (sim.foot_radius
                                                 + sim.contact_enter_margin)
    return LoopState(
        q=q0, v=v0, st=state0, t0=torch.zeros(B, dtype=dtype, device=dev),
        mc=mc0, trust=torch.full((B,), cfg.trust_region, dtype=dtype,
                                 device=dev),
        tick=torch.zeros((), dtype=torch.int64, device=dev))


def is_gait_period(index: int, gait_opt_every: int) -> bool:
    """Whether MPC period ``index`` runs the gait update in place of an RTI
    (every ``gait_opt_every``-th period after the first; 0 = never)."""
    return gait_opt_every > 0 and index > 0 and index % gait_opt_every == 0


def mpc_update(model: RobotModel, params: srb.SRBParams, cfg: MPCConfig,
               ls: LoopState, t: torch.Tensor, x_des_tan: torch.Tensor,
               feet: torch.Tensor, mc: torch.Tensor, *, gait: bool,
               contact_sync: bool, call: Callable = plain_call):
    """The MPC update of a period's first tick at time t [B] from the
    loop's state, the measured feet [B, E, 3] and the latched contact
    mc [B, E]: an RTI, or the gait update (which embeds the RTI).  Returns
    (state, the RTI's SolveStats (each [B]), trust [B]).  ``call``: the
    stage hook (``mpc_controller.plain_call``) of the SRB state and of the
    RTI or the gait update."""
    x_srb = call("srb_state", lambda q, v:
                 mpc_controller.reconstruct_srb_state(model, params, q, v),
                 ls.q, ls.v)
    st = ls.st
    if contact_sync:
        # early-touchdown schedule sync, fed by the latched contact state
        sched = gait_mod.adjust_for_current_contacts(
            st.traj.sched, mc, t, window=cfg.contact_snap_window)
        st = dataclasses.replace(st, traj=dataclasses.replace(st.traj,
                                                              sched=sched))
    if gait:
        res = call("gait_opt_update", lambda st, x, t, f, xd, tr:
                   bilevel_mod.gait_opt_update(cfg, params, st, x, t, f, xd,
                                               trust=tr),
                   st, x_srb, t, feet, x_des_tan, ls.trust)
        return res.state, res.rti_stats, res.trust
    st2, stats = call("rti", lambda st, x, t, f, xd: solver_mod.solve_step(
        cfg, params, st, x, t, f, xd), st, x_srb, t, feet, x_des_tan)
    return st2, stats, ls.trust


def latch_contact(sim: SimConfig, feet: torch.Tensor,
                  mc_prev: torch.Tensor) -> torch.Tensor:
    """The hysteresis contact latch [B, E]: a foot enters contact below
    foot_radius + enter_margin and leaves above foot_radius + exit_margin,
    so that stance holds through the penalty ground's micro-bounces."""
    z = feet[..., 2]
    return (z < sim.foot_radius + sim.contact_enter_margin) | (
        mc_prev & (z < sim.foot_radius + sim.contact_exit_margin))


def control_tick(model: RobotModel, params: srb.SRBParams, cfg: MPCConfig,
                 wb_cfg: wbqp.WBQPConfig, sim: SimConfig,
                 st: solver_mod.SolverState, q: torch.Tensor,
                 v: torch.Tensor, t: torch.Tensor, t0: torch.Tensor,
                 mc: torch.Tensor, *, control_dt: float,
                 call: Callable = plain_call):
    """One control tick after the MPC update: the torque QP on the MPC
    state ``st`` at time t [B], then ``sim.substeps`` physics steps.
    Returns (q, v, tau).  ``call``: the stage hook of the controller's
    stages and of each physics step ("physics_1", ...)."""
    tau = mpc_controller.control_action(model, params, cfg, wb_cfg, st.traj,
                                        q, v, t, t0, mc, call=call)
    dt = control_dt / sim.substeps
    for k in range(sim.substeps):
        q, v = call(f"physics_{k + 1}", lambda q, v, tau: physics_step(
            model, sim, q, v, tau, dt), q, v, tau)
    return q, v, tau


def period(model: RobotModel, params: srb.SRBParams, cfg: MPCConfig,
           wb_cfg: wbqp.WBQPConfig, sim: SimConfig, x_des_tan: torch.Tensor,
           ls: LoopState, *, control_dt: float, ticks: int, gait: bool,
           contact_sync: bool, call: Callable = plain_call
           ) -> tuple[LoopState, SimLog]:
    """One MPC period of ``ticks`` ticks from ``ls``: the MPC update (the
    gait update if ``gait``) on the first, and on every tick the contact
    latch and a :func:`control_tick`.  Returns the state after the period
    and its log, fields [ticks, B, ...].  ``call``: the stage hook
    (``mpc_controller.plain_call``) through which every stage of a tick
    runs, in order: "ee_positions", "latch_contact", on the first tick
    "srb_state" and "rti" or "gait_opt_update", then the controller's
    stages (``mpc_controller.control_action_full``) and "physics_1" to
    "physics_<substeps>"."""
    q, v, st, t0, mc, trust = ls.q, ls.v, ls.st, ls.t0, ls.mc, ls.trust
    B, dtype = q.shape[0], q.dtype
    logs = []
    for j in range(ticks):
        t = ((ls.tick + j).to(dtype) * control_dt).expand(B)
        feet = call("ee_positions", lambda q: rbd.ee_positions(model, q), q)
        mc = call("latch_contact", lambda f, c: latch_contact(sim, f, c),
                  feet, mc)
        if j == 0:
            st, stats, trust = mpc_update(
                model, params, cfg, ls, t, x_des_tan, feet, mc, gait=gait,
                contact_sync=contact_sync, call=call)
            cost, solved = stats.cost, stats.solved
            t0 = t
        else:
            cost = torch.full((B,), float("nan"), dtype=dtype,
                              device=q.device)
            solved = torch.ones(B, dtype=torch.bool, device=q.device)
        q, v, tau = control_tick(model, params, cfg, wb_cfg, sim, st, q, v,
                                 t, t0, mc, control_dt=control_dt, call=call)
        x_srb = mpc_controller.reconstruct_srb_state(model, params, q, v)
        logs.append(SimLog(q=q, v=v, srb_state=x_srb, tau=tau, cost=cost,
                           solved=solved))
    out = LoopState(q=q, v=v, st=st, t0=t0, mc=mc, trust=trust,
                    tick=ls.tick + ticks)
    return out, SimLog(*(torch.stack(f) for f in zip(*logs)))

