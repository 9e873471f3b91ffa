"""The A1 bench problem for the port (``make_problem`` of the repository's
``bench.py``, batch first).

B scenarios share the standing A1, its trot schedule and its initial
trajectory; each measures a perturbed initial state.  The perturbation is
drawn with numpy from ``seed`` (the JAX bench draws it with ``jax.random``,
so the two give different numbers from the same seed).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc import gait, solver
from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig


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


def perturbations(batch: int, seed: int = 0) -> np.ndarray:
    """[batch, 13] state perturbations, 0.02 * N(0, 1), none on the
    quaternion."""
    pert = 0.02 * np.random.default_rng(seed).standard_normal((batch, 13))
    pert[:, 6:10] = 0.0
    return pert


def make_problem(cfg: MPCConfig, batch: int, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 push_vx: float = 0.0, stretch: float = 1.0) -> Problem:
    """``push_vx`` [m/s] starts the robot with that forward velocity (the
    linear momentum mass * push_vx); ``stretch`` scales every phase boundary
    (the mistimed schedules of the bench's A/B grid).  ``device`` defaults
    to the GPU."""
    device = resolve_device(device)
    model = a1.make_a1(device=device)
    q0 = torch.tensor(a1.stand_config(), device=device).to(dtype)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0,
                               torch.zeros(model.nv, dtype=dtype,
                                           device=device))
    if push_vx:
        x0[3] = params.mass * push_vx
    feet0 = rbd.ee_positions(model, q0).to(dtype)
    sched = gait.make_trot(cfg, dtype=dtype, device=device)
    if stretch != 1.0:
        sched = gait.GaitSchedule(bounds=sched.bounds * stretch)
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
    pert = torch.tensor(perturbations(batch, seed), device=device).to(dtype)
    return Problem(params=params, states=states, x0s=x0b + pert,
                   t0=torch.zeros(batch, dtype=dtype, device=device),
                   feets=feets, x_des=x_des)
