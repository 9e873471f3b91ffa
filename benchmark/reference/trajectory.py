"""Trajectory: the MPC solution container (port of
``bilevel_gait_gen_tpu/mpc/trajectory.py``), batch first."""
from __future__ import annotations

import dataclasses

import torch

from .gait import GaitSchedule
from .config import MPCConfig


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """x_man [B, N+1, 13]; f_nodes [B, E, S, F-1, 3, 2]; footholds
    [B, E, S+1, 2]; sched.bounds [B, E, P+1]."""
    x_man: torch.Tensor
    f_nodes: torch.Tensor
    footholds: torch.Tensor
    sched: GaitSchedule


def ravel_u(f_nodes: torch.Tensor, footholds: torch.Tensor) -> torch.Tensor:
    """Flat input vector [..., n_u] = [forces | footholds]."""
    lead = footholds.shape[:-3]
    return torch.cat([f_nodes.reshape(*lead, -1),
                      footholds.reshape(*lead, -1)], dim=-1)


def make_unravel(cfg: MPCConfig):
    E, S, F = cfg.num_ee, cfg.num_stance_slots, cfg.num_force_polys
    nf = cfg.num_force_vars

    def unravel(u: torch.Tensor):
        lead = u.shape[:-1]
        f_nodes = u[..., :nf].reshape(*lead, E, S, F - 1, 3, 2)
        footholds = u[..., nf:].reshape(*lead, E, cfg.num_footholds, 2)
        return f_nodes, footholds

    return unravel


def default_trajectory(cfg: MPCConfig, sched: GaitSchedule,
                       x0_man: torch.Tensor,
                       ee_xy: torch.Tensor) -> Trajectory:
    """Initial warm start: constant state [B, 13], footholds at the current
    feet [B, E, 2], zero force nodes; ``sched.bounds`` ([E, P+1] or
    [B, E, P+1]) is broadcast over the batch and cast to the state dtype."""
    E, S, F = cfg.num_ee, cfg.num_stance_slots, cfg.num_force_polys
    dtype = x0_man.dtype
    lead = x0_man.shape[:-1]
    x_man = x0_man[..., None, :].expand(
        *lead, cfg.num_nodes + 1, x0_man.shape[-1]).clone()
    f_nodes = torch.zeros(*lead, E, S, F - 1, 3, 2, dtype=dtype,
                          device=x0_man.device)
    footholds = ee_xy.to(dtype)[..., :, None, :].expand(
        *lead, E, cfg.num_footholds, 2).clone()
    bounds = sched.bounds.to(dtype).expand(
        *lead, *sched.bounds.shape[-2:]).clone()
    return Trajectory(x_man=x_man, f_nodes=f_nodes, footholds=footholds,
                      sched=GaitSchedule(bounds=bounds))
