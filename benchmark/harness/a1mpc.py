"""The A1 bench problem on both sides: the program's, made by its own entry
point (``problem.make_problem``) with the measured states the seed gives,
and the reference's, worked out again from the same perturbations; and the
comparison of the two starts."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.harness import compare, seeds
from benchmark.reference import start as ref_start


def program_config(fields: dict):
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in fields.items()}).validate()


def perturbations(ctx, batch: int) -> np.ndarray:
    return seeds.perturbations(batch, ctx.seed, ctx.traffic["perturbation"])


def program_problem(cfg, batch: int, pert: np.ndarray, device):
    """The port's bench problem at ``batch`` in float32, its measured
    states x0 + ``pert`` (the port's own draw is replaced)."""
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg, batch, device=device, dtype=torch.float32)
    x0 = pr.states.traj.x_man[:, 0]
    x0s = x0 + torch.tensor(pert, dtype=torch.float64,
                            device=device).to(torch.float32)
    return dataclasses.replace(pr, x0s=x0s)


def reference_problem(ref_cfg, pert: np.ndarray, device,
                      dtype: torch.dtype = torch.float64):
    return ref_start.make_problem(ref_cfg, pert.shape[0], pert,
                                  device=device, dtype=dtype)


def start_gap(pr, rp) -> float:
    """The program's problem against the reference's: the largest relative
    gap over the SRB constants, the initial trajectory, the warm start's
    sentinel, the EE boxes and the measured states, feet and targets."""
    parts = [(getattr(pr.params, f.name), getattr(rp.params, f.name))
             for f in dataclasses.fields(pr.params)]
    st, rs = pr.states, rp.states
    parts += [(st.traj.x_man, rs.traj.x_man), (st.traj.f_nodes,
                                                rs.traj.f_nodes),
              (st.traj.footholds, rs.traj.footholds),
              (st.traj.sched.bounds, rs.traj.sched.bounds),
              (st.ee_box, rs.ee_box), (pr.x0s, rp.x0s), (pr.t0, rp.t0),
              (pr.feets, rp.feets), (pr.x_des, rp.x_des)]
    parts += [(getattr(st.qp_warm, f.name), getattr(rs.qp_warm, f.name))
              for f in dataclasses.fields(st.qp_warm)]
    return max(compare.rel_gap(a, b) for a, b in parts)
