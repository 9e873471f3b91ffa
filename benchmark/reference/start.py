"""The reference's own starts, worked out again from the seed's inputs:
the bench problem (``problem.make_problem`` of the port, batch first) and
the flagship closed loop's start (``chip_smoke.loop_start``).

B scenarios share the standing A1, its trot schedule and its initial
trajectory; each measures a perturbed initial state, handed in as
``pert`` [B, 13] (the benchmark draws it from the seed).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import a1, gait, rbd, solver, srb
from .config import MPCConfig
from .consts import resolve_device
from .srb import SRBParams
from .trajectory import default_trajectory


@dataclasses.dataclass(frozen=True)
class Problem:
    params: SRBParams
    states: solver.SolverState   # [B] scenarios, warm start = sentinel
    x0s: torch.Tensor            # [B, 13] measured states
    t0: torch.Tensor             # [B] window start times
    feets: torch.Tensor          # [B, E, 3] measured feet
    x_des: torch.Tensor          # [B, 12] tracking target (tangent)

    def loop_args(self):
        """The arguments after ``params`` of ``solver.solve_step`` and of
        the ``mpc/cadence.py`` loops: (states, x0s, t0, feets, x_des)."""
        return self.states, self.x0s, self.t0, self.feets, self.x_des


def make_problem(cfg: MPCConfig, batch: int, pert: np.ndarray, *, device,
                 dtype: torch.dtype = torch.float64) -> Problem:
    """The bench problem with the measured states x0 + ``pert``."""
    device = resolve_device(device)
    model = a1.make_a1(device=device)
    q0 = torch.tensor(a1.stand_config(), device=device).to(dtype)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0,
                               torch.zeros(model.nv, dtype=dtype,
                                           device=device))
    feet0 = rbd.ee_positions(model, q0).to(dtype)
    sched = gait.make_trot(cfg, dtype=dtype, device=device)
    x0b = x0.expand(batch, -1)
    feets = feet0.expand(batch, -1, -1).contiguous()
    traj = default_trajectory(cfg, sched, x0b, feets[..., :2])
    box = torch.tensor(cfg.ee_box_size, dtype=dtype,
                       device=device).expand(batch, 2).contiguous()
    states = solver.make_state(cfg, traj, box)
    x_stand = x0.clone()
    x_stand[3:6] = 0.0
    x_stand[10:13] = 0.0
    x_des = srb.manifold_to_tangent(x_stand).expand(batch, -1).contiguous()
    pert = torch.tensor(pert, device=device).to(dtype)
    return Problem(params=params, states=states, x0s=x0b + pert,
                   t0=torch.zeros(batch, dtype=dtype, device=device),
                   feets=feets, x_des=x_des)


def loop_start(cfg: MPCConfig, sim, stretch: float, dq: np.ndarray, *,
               device, dtype: torch.dtype = torch.float64):
    """The flagship closed loop's start, batch first: the settled stand, a
    trot with every phase bound x ``stretch``, ``create_initial_run`` once,
    then one scenario of that plan per row of ``dq`` [B, joints], the
    joints moved by it.  Returns (model, params, state, q0 [B, nq],
    v0 [B, nv], x_des [B, 12], the initial run's solved flag [1])."""
    from . import engine, mpc_controller
    from .trajectory import default_trajectory as default_traj
    batch = dq.shape[0]
    model = a1.make_a1(device=device)
    stand = torch.tensor(a1.stand_config(), dtype=dtype, device=device)
    q0 = engine.settled_stand(model, sim, stand)
    params = srb.make_srb_params(model, q0)
    x0 = mpc_controller.reconstruct_srb_state(model, params, q0,
                                              torch.zeros_like(q0[1:]))
    feet0 = rbd.ee_positions(model, q0)
    sched = gait.GaitSchedule(bounds=gait.make_trot(
        cfg, dtype=dtype, device=device).bounds * stretch)
    traj = default_traj(cfg, sched, x0[None], feet0[None, :, :2])
    st = solver.make_state(cfg, traj, torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    x_des = srb.manifold_to_tangent(x0)[None]
    st, stats = solver.create_initial_run(cfg, params, st, x0[None],
                                          feet0[None], x_des)
    q0s = q0.expand(batch, -1) + torch.cat([
        torch.zeros(batch, 7, dtype=dtype, device=device),
        torch.tensor(dq, dtype=dtype, device=device)], dim=-1)

    def rows(a):
        return a.expand(batch, *a.shape[1:]).clone()

    states = solver.SolverState(
        traj=dataclasses.replace(
            st.traj, x_man=rows(st.traj.x_man), f_nodes=rows(st.traj.f_nodes),
            footholds=rows(st.traj.footholds),
            sched=gait.GaitSchedule(bounds=rows(st.traj.sched.bounds))),
        ee_box=rows(st.ee_box),
        qp_warm=dataclasses.replace(st.qp_warm, **{
            f.name: rows(getattr(st.qp_warm, f.name))
            for f in dataclasses.fields(st.qp_warm)}))
    return (model, params, states, q0s,
            torch.zeros(batch, model.nv, dtype=dtype, device=device),
            x_des.expand(batch, -1).clone(), stats.solved)
