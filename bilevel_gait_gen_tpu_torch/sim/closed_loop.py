"""Reusable closed-loop MuJoCo harness: MPC RTIs + whole-body QP torques
(port of ``bilevel_gait_gen_tpu/sim/closed_loop.py``; the reference
scenarios and the rationale of every policy are documented there).

:func:`run_closed_loop` packages the control stack around
:class:`~bilevel_gait_gen_tpu_torch.sim.mujoco_bridge.MujocoLoop`: one MPC
real-time iteration per ``cfg.dt`` with the early-touchdown schedule sync,
the bilevel gait update every ``gait_opt_freq`` RTIs, goal carrots with an
arrival state machine that switches to a standing MPC, mid-run velocity
pushes and the flight-phase schedule hold.

The JAX package's ``control_fn`` closure and its ``holder`` state are one
object here, :class:`ClosedLoopController`, called with the measured
contacts passed in: ``ctl(q, v, t, mc) -> tau``.  ``run_closed_loop``
drives it through ``MujocoLoop`` as the JAX package does; any other plant
that hands it (q, v, t, contacts) drives the same controller.  It runs at
batch 1.  The JAX package's jitted functions (the initial run, the RTI,
the gait update and the control tick, and the standing MPC's three after a
carrot's arrival) run eagerly on the CPU; on the card each is a
:class:`~bilevel_gait_gen_tpu_torch.utils.graphs.Graphed` captured at its
first use and held there to that use's eager call bit for bit.  Neither
``mujoco`` nor anything else outside torch and numpy is imported with
this module: ``MujocoLoop`` imports ``mujoco`` when it is made.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.control import mpc_controller, wbqp
from bilevel_gait_gen_tpu_torch.models import rbd, srb
from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel
from bilevel_gait_gen_tpu_torch.mpc import bilevel, gait, solver
from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu_torch.sim.mujoco_bridge import MujocoLoop
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch.utils.graphs import FirstUseGraphs, tree_map


class ClosedLoopResult(NamedTuple):
    qs: np.ndarray          # [T, nq] MuJoCo-logged configurations
    vs: np.ndarray          # [T, nv]
    taus: np.ndarray        # [T, nj]
    n_mpc: int
    n_fails: int
    n_gait_accepts: int
    costs: np.ndarray = np.zeros(0)        # per-MPC-tick planning cost
    final_bounds: np.ndarray = np.zeros(0)  # final schedule bounds [E, P+1]
    arrived_t: float = -1.0   # goal-arrival time (standing switch), -1 never
    mpc_ms: float = 0.0       # mean wall ms per MPC tick
    ctrl_ms: float = 0.0      # mean wall ms per control tick
    flight_s: float = 0.0     # total airborne (no-contact) time [s]
    # last MPC state (plan), each tensor at the JAX package's shape: the
    # batch of one squeezed (``tree_map(lambda t: t[None], s)`` gives back
    # the port's batch-first state)
    final_state: "solver.SolverState | None" = None

    @property
    def z(self) -> np.ndarray:
        return self.qs[:, 2]

    def recovered(self, z_min: float = 0.15,
                  v_end_max: float = 0.25) -> bool:
        """Upright throughout AND the push arrested by the end."""
        v_end = float(np.abs(self.vs[-500:, 0:2]).mean(axis=0).max())
        return bool(self.z.min() > z_min and v_end < v_end_max)


@dataclasses.dataclass(frozen=True)
class GoalCarrot:
    """Walk-to-position carrot: the commanded target is at most ``radius``
    of the remaining goal per plan, tapered near arrival; ``vel_carrot``
    adds a momentum command with an integral trim ``ki`` capped per axis by
    ``int_cap`` (lateral cap zero).  The JAX package's docstring gives the
    measurements behind each default."""
    goal: tuple[float, float]          # (x, y) offset from the start pos
    radius: float = 0.25               # max commanded position step [m]
    lat_cap: float = 0.08              # lateral position-step cap [m]
    vel_carrot: bool = False
    v_walk: float = 0.10               # walking-speed command [m/s]
    v_lat_cap: float = 0.05
    v_deadband: float = 0.10           # march-in-place inside this range
    ki: float = 0.0                    # integral velocity trim [1/s], 0 off
    int_cap: tuple = (0.06, 0.0)       # per-axis integral cap [m/s]
    v_floor: float = 0.0               # optional approach-speed floor
    stand_on_arrival: bool = True
    arrive_err: float = 0.07
    arrive_speed: float = 0.06


def settled_start(model: RobotModel, q_stand: np.ndarray,
                  foot_radius: float = 0.02,
                  penetration: float = 0.0015) -> np.ndarray:
    """Drop the stand config so every foot rests `penetration` into the
    ground plane (a hovering pair destroys standing)."""
    q = np.asarray(q_stand, np.float64).copy()
    feet_z = rbd.ee_positions(model, torch.from_numpy(q.copy()).to(
        model.mass.device))[:, 2]
    q[2] -= float(torch.max(feet_z)) - foot_radius + penetration
    return q


class ClosedLoopController:
    """The control stack of one robot, batch 1: ``ctl(q, v, t, mc)`` takes
    the measured configuration q [nq] and velocity v [nv] (numpy, the port's
    conventions), the time t (a Python float) and the measured contacts mc
    [E] (bool) and returns the joint torques [nj] as numpy.  Every
    ``cfg.dt`` it first runs an MPC update (the RTI, or the gait update in
    its place every ``gait_opt_freq``-th time; the standing MPC after a
    carrot's arrival).  The arguments are :func:`run_closed_loop`'s.

    :attr:`fns` holds the functions that run as graphs on the card, by
    name (``init_run``, ``rti``, ``gait``, ``tick`` and, after an arrival,
    ``init_stand``, ``rti_stand``, ``tick_stand``); :attr:`runs` (a
    :class:`~bilevel_gait_gen_tpu_torch.utils.graphs.FirstUseGraphs`: its
    ``graphs``, ``first_args``, ``eager_ms`` and ``compared``) what became
    of each on the card."""

    def __init__(self, model: RobotModel, cfg: MPCConfig,
                 wb_cfg: "wbqp.WBQPConfig", q0: np.ndarray, v0: np.ndarray,
                 sched: gait.GaitSchedule | None = None,
                 x_des_man: torch.Tensor | None = None,
                 gait_opt_freq: int = 0, carrot: GoalCarrot | None = None,
                 stand_cfg: MPCConfig | None = None, viewer: bool = False,
                 debug: bool = False, flight_resync: bool = True,
                 flight_dwell: float = 0.0, recede_target: float = 0.0,
                 device=None, dtype: torch.dtype = torch.float32):
        dev = resolve_device(device)
        self.model, self.cfg, self.wb_cfg = model, cfg, wb_cfg
        self.gait_opt_freq, self.carrot = gait_opt_freq, carrot
        self.viewer, self.debug = viewer, debug
        self.flight_resync, self.flight_dwell = flight_resync, flight_dwell
        self.recede_target = recede_target
        self.device, self.dtype = dev, dtype
        self.graphed = dev.type == "cuda"
        self.runs = FirstUseGraphs(dev)

        q0t = torch.as_tensor(np.asarray(q0), device=dev).to(dtype)
        v0t = torch.as_tensor(np.asarray(v0), device=dev).to(dtype)
        params = self.params = srb.make_srb_params(model, q0t)
        self.mass = float(params.mass)
        x0 = srb.reconstruct_state(params, q0t, v0t)[None]
        feet0 = rbd.ee_positions(model, q0t).to(dtype)[None]
        if sched is None:
            sched = gait.make_trot(cfg, dtype=dtype, device=dev)
        traj = default_trajectory(cfg, sched, x0, feet0[..., :2])
        state = solver.SolverState(traj=traj, ee_box=self._box(cfg))
        # the start pose with ZERO momentum
        self.x_rest = x0.clone()
        self.x_rest[:, 3:6] = 0.0
        self.x_rest[:, 10:13] = 0.0
        if x_des_man is None:
            # reject the push: nominal pose, ZERO momentum
            x_des_man = self.x_rest
        else:
            x_des_man = torch.as_tensor(x_des_man, device=dev).to(
                dtype).reshape(1, -1)
        self.x_des = srb.manifold_to_tangent(x_des_man)

        self.fns = {
            "init_run": lambda st, x, ee, xd: solver.create_initial_run(
                cfg, params, st, x, ee, xd),
            "rti": lambda st, x, t, ee, xd: solver.solve_step(
                cfg, params, st, x, t, ee, xd),
            # cfg.gait_bfgs threads the damped-BFGS curvature carry
            "gait": lambda st, x, t, ee, xd, tr, cv: bilevel.gait_opt_update(
                cfg, params, st, x, t, ee, xd, trust=tr, curv=cv),
            "tick": lambda tr, q, v, t, t0, mc: mpc_controller.control_action(
                model, params, cfg, wb_cfg, tr, q, v, t, t0, mc)}
        state, _ = self._run("init_run", state, x0, feet0, self.x_des)
        self._sync()

        # the goal/arrival bookkeeping targets the SRB COM (x0) while the
        # plant reports the BASE position q[0:2]: the constant COM-to-base
        # xy offset at the start pose removes the bias from the arrival gate
        x0h = x0[0].cpu().numpy()
        self.com_off = np.asarray([float(x0h[0]) - float(q0[0]),
                                   float(x0h[1]) - float(q0[1])])
        self.tgt_xy = None
        if carrot is not None:
            self.tgt_xy = np.asarray([float(x0h[0]) + carrot.goal[0],
                                      float(x0h[1]) + carrot.goal[1]])
            self.tgt = torch.tensor(self.tgt_xy, dtype=dtype,
                                    device=dev)[None]
            if stand_cfg is None:
                stand_cfg = dataclasses.replace(
                    cfg, force_carrier=True, carrier_ramp=0.1).validate()
            self.fns.update({
                "init_stand": lambda st, x, ee, xd: solver.create_initial_run(
                    stand_cfg, params, st, x, ee, xd),
                "rti_stand": lambda st, x, t, ee, xd: solver.solve_step(
                    stand_cfg, params, st, x, t, ee, xd),
                "tick_stand": lambda tr, q, v, t, t0, mc:
                    mpc_controller.control_action(
                        model, params, stand_cfg, wb_cfg, tr, q, v, t, t0,
                        mc)})
        self.stand_cfg = stand_cfg

        self.state, self.t0, self.n, self.fails, self.accepts = (
            state, 0.0, 0, 0, 0)
        self.trust = torch.full((1,), cfg.trust_region, dtype=dtype,
                                device=dev)
        self.standing, self.arrived_t, self.costs = False, -1.0, []
        self.mpc_ms, self.ctrl_ms, self.n_ctrl = 0.0, 0.0, 0
        self.slip, self.flight_s, self.flight_run = 0.0, 0.0, 0.0
        self.v_int = np.zeros(2)
        self.curv = (bilevel.init_curvature(cfg, 1, dtype=dtype, device=dev)
                     if cfg.gait_bfgs else None)
        self.overlay = None

    def _box(self, cfg: MPCConfig) -> torch.Tensor:
        return torch.tensor([cfg.ee_box_size], dtype=self.dtype,
                            device=self.device)

    def _sync(self) -> None:
        if self.graphed:
            torch.cuda.synchronize(self.device)

    def _run(self, name: str, *args):
        """``fns[name](*args)``: eagerly on the CPU; on the card through
        its graph, captured at the first call and held there to the eager
        call bit for bit."""
        return self.runs(name, self.fns[name], *args)

    def _goal(self, x_srb: torch.Tensor) -> torch.Tensor:
        """The commanded tangent state [1, 12] at the SRB state x_srb
        [1, 13]: the push-recovery stopping point, a tapered receding carrot
        toward the goal, or the fixed target."""
        carrot, mass = self.carrot, self.mass
        if carrot is None:
            if self.recede_target > 0.0:
                # stopping-point target: the spot the COM reaches after T
                # more seconds of current drift, x + T v, capped at 0.15 m
                v_xy = x_srb[:, 3:5] / mass
                step = self.recede_target * v_xy
                nrm = torch.sqrt(torch.sum(step * step, -1, keepdim=True))
                step = step * (torch.clamp_max(nrm, 0.15) / (nrm + 1e-9))
                x_t = self.x_rest.clone()
                x_t[:, 0:2] = x_srb[:, 0:2] + step
                return srb.manifold_to_tangent(x_t)
            return self.x_des
        c = carrot
        d = self.tgt - x_srb[:, 0:2]
        n = torch.sqrt(torch.sum(d * d, -1, keepdim=True))
        # taper near the goal: a gentle stop, not a push-recovery event
        r_eff = torch.clamp_max(0.6 * n, c.radius)
        step_xy = torch.where(n > r_eff, d * (r_eff / (n + 1e-9)), d)
        # lateral cap: trot lateral stepping is narrower than fore-aft
        step_xy[:, 1] = torch.clamp(step_xy[:, 1], -c.lat_cap, c.lat_cap)
        x_t = self.x_rest.clone()
        x_t[:, 0:2] = x_srb[:, 0:2] + step_xy
        if c.vel_carrot:
            # momentum carrot for foot-placement walkers, deadband near the
            # goal, the integral trim held in float64 numpy
            spd = torch.clamp(0.5 * n, c.v_floor, c.v_walk)
            v_des = d * (spd / (n + 1e-9))
            v_des = v_des * (n > c.v_deadband)
            v_des[:, 1] = torch.clamp(v_des[:, 1], -c.v_lat_cap, c.v_lat_cap)
            if c.ki > 0.0:
                v_act = x_srb[:, 3:5] / mass
                vi = self.v_int + c.ki * self.cfg.dt * (
                    v_des - v_act)[0].cpu().numpy()
                cap = np.asarray(c.int_cap)
                self.v_int = np.clip(vi, -cap, cap)
                v_des = v_des + torch.tensor(self.v_int, dtype=self.dtype,
                                             device=self.device)
            x_t[:, 3:5] = mass * v_des
        return srb.manifold_to_tangent(x_t)

    def _mpc_tick(self, qj, vj, tt, t: float, mc, mc_np):
        """The MPC update of the tick at time t."""
        cfg = self.cfg
        tm = time.perf_counter()
        x_srb = srb.reconstruct_state(self.params, qj, vj)
        feet = rbd.ee_positions(self.model, qj)
        st_in = self.state
        if self.slip > 0.0:
            # flight-phase schedule hold: the airborne time accrued at
            # control rate since the last MPC tick, in the state's dtype
            slip = torch.tensor(self.slip, dtype=self.dtype,
                                device=self.device)
            st_in = dataclasses.replace(
                st_in, traj=dataclasses.replace(
                    st_in.traj, sched=gait.GaitSchedule(
                        bounds=st_in.traj.sched.bounds + slip)))
            self.slip = 0.0
        sched2 = gait.adjust_for_current_contacts(
            st_in.traj.sched, mc, tt, window=cfg.contact_snap_window)
        st_in = dataclasses.replace(
            st_in, traj=dataclasses.replace(st_in.traj, sched=sched2))
        xd = self._goal(x_srb)
        if self.standing:
            st, stats = self._run("rti_stand", st_in, x_srb, tt, feet, xd)
        elif self.gait_opt_freq and self.n % self.gait_opt_freq \
                == self.gait_opt_freq - 1:
            # the gait update embeds the production RTI
            res = self._run("gait", st_in, x_srb, tt, feet, xd, self.trust,
                            self.curv)
            st, stats = res.state, res.rti_stats
            self.trust, self.curv = res.trust, res.curv
            self.accepts += int(bool(res.accepted[0]))
        else:
            st, stats = self._run("rti", st_in, x_srb, tt, feet, xd)
        self._sync()
        self.state = st
        if self.viewer:
            # live plan overlay: planned COM trajectory, in-window
            # footholds, COM-relative EE boxes
            com0 = st.traj.x_man[0, 0, 0:2].cpu().numpy()
            hip = self.params.hip_offset.cpu().numpy()
            box = st.ee_box[0].cpu().numpy()
            self.overlay = {
                "com_traj": st.traj.x_man[0, :, 0:3].cpu().numpy(),
                "footholds": st.traj.footholds[0].cpu().numpy().reshape(
                    -1, 2),
                "ee_box": (com0[None, :] + hip,
                           tuple(box.reshape(-1)[:2]) if box.size >= 2
                           else (float(box),) * 2)}
        self.t0 = t
        self.n += 1
        self.mpc_ms += (time.perf_counter() - tm) * 1e3
        cost = float(stats.cost[0])
        self.costs.append(cost)
        if not bool(stats.solved[0]):
            self.fails += 1
        if self.debug:
            b = st.traj.sched.bounds[0].cpu().numpy()
            lens = (b[:, 1:] - b[:, :-1])[
                (b[:, 1:] > t) & (b[:, :-1] < t + cfg.horizon)]
            mcs = "".join("#" if c else "." for c in mc_np)
            q, v = qj[0].cpu().numpy(), vj[0].cpu().numpy()
            print(f"  t={t:.2f} cost={cost:+.0f} "
                  f"defect={float(stats.defect_l1[0]):.2e} "
                  f"alpha={float(stats.alpha[0]):.2f} "
                  f"x={q[0]:+.3f} z={q[2]:.3f} vx={v[0]:+.3f} "
                  f"mc={mcs} fl={self.flight_s:.3f} "
                  f"ph=[{lens.min():.3f},{lens.max():.3f}]")

    def _arrive(self, q, v, qj, vj, t: float, mc_np) -> None:
        """The arrival state machine at control rate: at the goal, slow and
        with all feet planted, switch to the standing MPC."""
        carrot = self.carrot
        err = float(np.hypot(q[0] + self.com_off[0] - self.tgt_xy[0],
                             q[1] + self.com_off[1] - self.tgt_xy[1]))
        spd = float(np.linalg.norm(np.asarray(v[0:2])))
        if not (err < carrot.arrive_err and spd < carrot.arrive_speed
                and bool(np.all(mc_np))):
            return
        stand_cfg = self.stand_cfg
        x_srb_a = srb.reconstruct_state(self.params, qj, vj)
        feet_a = rbd.ee_positions(self.model, qj)
        sched_s = gait.make_standing(stand_cfg, t0=float(t), dtype=self.dtype,
                                     device=self.device)
        traj_s = default_trajectory(stand_cfg, sched_s, x_srb_a,
                                    feet_a[..., :2])
        st_s = solver.SolverState(traj=traj_s, ee_box=self._box(stand_cfg))
        st_s, _ = self._run("init_stand", st_s, x_srb_a, feet_a,
                            self._goal(x_srb_a))
        self.state = st_s
        self.t0 = t
        self.standing = True
        self.arrived_t = t
        # drop the flight slip accrued while walking: applied to the fresh
        # standing schedule it would shift it
        self.slip = 0.0
        self.flight_run = 0.0
        if self.debug:
            print(f"  arrived (err {err:.3f} m) -> MPC stand at t={t:.2f}")

    def __call__(self, q: np.ndarray, v: np.ndarray, t: float,
                 mc: np.ndarray) -> np.ndarray:
        dev, dtype = self.device, self.dtype
        qj = torch.as_tensor(np.asarray(q), device=dev).to(dtype)[None]
        vj = torch.as_tensor(np.asarray(v), device=dev).to(dtype)[None]
        tt = torch.full((1,), t, dtype=dtype, device=dev)
        mc_np = np.asarray(mc, bool)
        mct = torch.as_tensor(mc_np, device=dev)[None]
        if t >= self.t0 + self.cfg.dt or t == 0.0:
            self._mpc_tick(qj, vj, tt, t, mct, mc_np)
        tm = time.perf_counter()
        if (self.flight_resync and not self.standing
                and not bool(np.any(mc_np))):
            # airborne time accrued at control rate, applied as a schedule
            # hold at the next MPC tick; ``flight_dwell`` skips the first
            # seconds of each contiguous flight (bipeds)
            self.flight_run += 0.001
            self.flight_s += 0.001
            if self.flight_run > self.flight_dwell:
                self.slip += 0.001
        else:
            self.flight_run = 0.0
        if (self.carrot is not None and self.carrot.stand_on_arrival
                and not self.standing):
            self._arrive(q, v, qj, vj, t, mc_np)
        tau = self._run("tick_stand" if self.standing else "tick",
                        self.state.traj, qj, vj, tt,
                        torch.full((1,), self.t0, dtype=dtype, device=dev),
                        mct)
        tau_np = tau[0].cpu().numpy()
        self.ctrl_ms += (time.perf_counter() - tm) * 1e3
        self.n_ctrl += 1
        return tau_np

    def result(self, qs, vs, taus) -> ClosedLoopResult:
        """The run's :class:`ClosedLoopResult` around the plant's logs."""
        final = tree_map(lambda a: a[0].clone(), self.state)
        return ClosedLoopResult(
            qs=qs, vs=vs, taus=taus, n_mpc=self.n, n_fails=self.fails,
            n_gait_accepts=self.accepts, costs=np.asarray(self.costs),
            final_bounds=final.traj.sched.bounds.cpu().numpy(),
            arrived_t=self.arrived_t, mpc_ms=self.mpc_ms / max(self.n, 1),
            ctrl_ms=self.ctrl_ms / max(self.n_ctrl, 1),
            flight_s=self.flight_s, final_state=final)

    def close(self) -> None:
        """Free the graphs (once nothing holds their results)."""
        self.runs.close()


def run_closed_loop(model: RobotModel, cfg: MPCConfig,
                    wb_cfg: "wbqp.WBQPConfig", q0: np.ndarray,
                    v0: np.ndarray, seconds: float,
                    sched: gait.GaitSchedule | None = None,
                    x_des_man: torch.Tensor | None = None,
                    gait_opt_freq: int = 0,
                    carrot: GoalCarrot | None = None,
                    stand_cfg: MPCConfig | None = None,
                    push: tuple[float, float] | None = None,
                    viewer: bool = False, realtime: bool = False,
                    debug: bool = False, flight_resync: bool = True,
                    flight_dwell: float = 0.0,
                    recede_target: float = 0.0,
                    lowlevel_log: str | None = None,
                    log_decimation: int = 10, device=None,
                    dtype: torch.dtype = torch.float32) -> ClosedLoopResult:
    """Run `seconds` of host-MuJoCo physics under the controller.

    The MPC runs one real-time iteration per `cfg.dt` with early-touchdown
    schedule sync; optional bilevel gait updates every `gait_opt_freq` RTIs.
    ``carrot``: walk to ``q0 + carrot.goal``; on arrival switch to a
    standing MPC built from ``stand_cfg`` (default: cfg + force carrier).
    ``push``: ``(t_push, dvx)`` adds a forward base-velocity impulse at
    ``t_push`` seconds.  ``lowlevel_log``: path for the decimated per-tick
    q/v/tau/GRF/contact stream (every ``log_decimation``-th control tick).
    ``device`` defaults to the GPU; the controller runs in ``dtype``.
    """
    ctl = ClosedLoopController(
        model, cfg, wb_cfg, q0, v0, sched=sched, x_des_man=x_des_man,
        gait_opt_freq=gait_opt_freq, carrot=carrot, stand_cfg=stand_cfg,
        viewer=viewer, debug=debug, flight_resync=flight_resync,
        flight_dwell=flight_dwell, recede_target=recede_target,
        device=device, dtype=dtype)
    loop = MujocoLoop(model, timestep=0.001)
    loop.set_state(np.asarray(q0, np.float64), np.asarray(v0, np.float64))
    llog = None
    if lowlevel_log is not None:
        from bilevel_gait_gen_tpu_torch.utils import lowlevel_log as llog_mod
        E = model.num_ee
        llog = llog_mod.LowLevelLog(
            lowlevel_log,
            fields=[("t", 1), ("q", model.nq), ("v", model.nv),
                    ("tau", model.num_joints), ("grf", 3 * E),
                    ("contact", E)],
            decimation=log_decimation)

    def control_fn(q, v, t):
        mc = loop.contacts()
        tau = ctl(q, v, t, mc)
        if ctl.overlay is not None:
            loop.overlay = ctl.overlay
        if llog is not None:
            llog.record(t=np.asarray([t]), q=np.asarray(q),
                        v=np.asarray(v), tau=tau,
                        grf=loop.contact_forces().reshape(-1),
                        contact=np.asarray(mc, np.float32))
        return tau

    n_steps = int(seconds * 1000)
    try:
        if push is not None and 0 < push[0] < seconds:
            n1 = int(push[0] * 1000)
            qs1, vs1, taus1 = loop.run(control_fn, n1, control_decimation=1,
                                       viewer=viewer, realtime=realtime)
            loop.mj_data.qvel[0] += push[1]
            qs2, vs2, taus2 = loop.run(
                lambda q, v, t: control_fn(q, v, t + push[0]),
                n_steps - n1, control_decimation=1, viewer=viewer,
                realtime=realtime)
            qs = np.concatenate([qs1, qs2])
            vs = np.concatenate([vs1, vs2])
            taus = np.concatenate([taus1, taus2])
        else:
            qs, vs, taus = loop.run(control_fn, n_steps, control_decimation=1,
                                    viewer=viewer, realtime=realtime)
        if llog is not None:
            llog.close()
        return ctl.result(qs, vs, taus)
    finally:
        ctl.close()


def push_recovery_scenario(init_vx: float = 0.375,
                           cfg: MPCConfig | None = None,
                           gait_opt_freq: int = 0, debug: bool = False,
                           flight_resync: bool = True,
                           recede_target: float = 0.4,
                           snap_window: float = 0.25, device=None):
    """The reference's push-recovery scenario on A1, as
    :func:`run_push_recovery` hands it to :func:`run_closed_loop`: the
    robot settled with ``init_vx`` forward base velocity (0.375, the
    reference's MuJoCo ``init_vel``) under the full stability toolkit
    (double-support overlap, static-support carrier, Raibert capture
    stepping).  Returns (model, cfg, wb_cfg, q0, v0, the controller's
    keyword arguments) for any plant that drives
    :class:`ClosedLoopController`."""
    from bilevel_gait_gen_tpu_torch.models import a1
    if cfg is None:
        cfg = MPCConfig(ipm_iters=18, double_support=0.1,
                        force_carrier=True, carrier_ramp=0.1,
                        raibert=True,
                        raibert_vel_gain=(1.8, 1.2),
                        contact_snap_window=snap_window).validate()
    model = a1.make_a1(device=resolve_device(device))
    q0 = settled_start(model, np.asarray(a1.stand_config(), np.float64))
    v0 = np.zeros(model.nv)
    v0[0] = init_vx
    return model, cfg, wbqp.WBQPConfig(), q0, v0, dict(
        gait_opt_freq=gait_opt_freq, debug=debug,
        flight_resync=flight_resync, recede_target=recede_target)


def run_push_recovery(init_vx: float = 0.375, seconds: float = 2.5,
                      cfg: MPCConfig | None = None,
                      gait_opt_freq: int = 0, debug: bool = False,
                      flight_resync: bool = True,
                      recede_target: float = 0.4,
                      snap_window: float = 0.25, device=None,
                      dtype: torch.dtype = torch.float32) -> ClosedLoopResult:
    """The reference's push-recovery scenario (:func:`push_recovery_scenario`)
    closed loop on A1 for ``seconds``."""
    dev = resolve_device(device)
    model, cfg, wb_cfg, q0, v0, kw = push_recovery_scenario(
        init_vx, cfg, gait_opt_freq, debug, flight_resync, recede_target,
        snap_window, device=dev)
    return run_closed_loop(model, cfg, wb_cfg, q0, v0, seconds, device=dev,
                           dtype=dtype, **kw)
