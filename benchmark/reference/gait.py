"""Gait schedules: fixed-shape contact-phase slots (port of
``bilevel_gait_gen_tpu/mpc/gait.py``).

``bounds`` is ``[..., E, P+1]`` (leading scenario dimensions allowed); even
slots are stance, odd slots swing.
"""
from __future__ import annotations

import dataclasses

import torch

from .consts import resolve_device
from . import jnp_compat as jc
from .config import MPCConfig


@dataclasses.dataclass(frozen=True)
class GaitSchedule:
    """bounds: [..., E, P+1] absolute phase boundary times, nondecreasing
    per row; slot p spans [bounds[..., p], bounds[..., p+1])."""
    bounds: torch.Tensor

    @property
    def num_phases(self) -> int:
        return self.bounds.shape[-1] - 1


def make_trot(cfg: MPCConfig, t0: float = 0.0, *, dtype: torch.dtype,
              device=None) -> GaitSchedule:
    """Default trot [E, P+1]: phases of ``phase_duration``, FR/RL starting
    in contact and FL/RR in swing (see the JAX docstring for the
    double-support variant).  ``device`` defaults to the GPU."""
    device = resolve_device(device)
    E, P, d = cfg.num_ee, cfg.num_phase_slots, cfg.phase_duration
    ov = cfg.double_support
    k = torch.arange(P + 1, dtype=dtype, device=device)
    even = k % 2 == 0
    base = t0 + k * d - torch.where(even, torch.full_like(k, ov),
                                    torch.zeros_like(k))
    rows = []
    for ee in range(E):
        start_in_contact = ee in (1, 2) if E == 4 else (ee % 2 == 1)
        rows.append(base if start_in_contact else base - d)
    return GaitSchedule(bounds=torch.stack(rows))


# ----------------------------------------------------------------------------
# Queries; ``t`` broadcasts against ``bounds.shape[:-1]``
# ----------------------------------------------------------------------------

def phase_index(bounds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Slot p with bounds[p] <= t < bounds[p+1], clipped to [0, P-1]; ties
    at a boundary resolve to the later slot."""
    P = bounds.shape[-1] - 1
    idx = torch.sum(t[..., None] >= bounds[..., 1:], dim=-1)
    return torch.clamp(idx, 0, P - 1)


def in_contact(bounds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return phase_index(bounds, t) % 2 == 0


def contact_flags(sched: GaitSchedule, t: torch.Tensor) -> torch.Tensor:
    """[..., E] stance flags at time t [...]."""
    return in_contact(sched.bounds, t[..., None])


def next_touchdown_time(bounds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Earliest stance-start boundary strictly after t."""
    starts = bounds[..., 0::2]
    big = bounds[..., -1:] + 1e6
    masked = torch.where(starts > t[..., None], starts, big)
    return torch.amin(masked, dim=-1)


def current_swing_time(bounds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Duration of the swing active (or next) at t."""
    p = phase_index(bounds, t)
    swing_slot = torch.where(p % 2 == 1, p,
                             torch.clamp(p + 1, max=bounds.shape[-1] - 2))
    return (jc.take(bounds, swing_slot + 1, -1)
            - jc.take(bounds, swing_slot, -1))


def _t_rows(t0: torch.Tensor) -> torch.Tensor:
    """Scenario times [...] -> [..., 1, 1] against bounds [..., E, P+1]."""
    return t0[..., None, None]


def advance_window(sched: GaitSchedule, t0: torch.Tensor,
                   cfg: MPCConfig) -> GaitSchedule:
    """Receding-horizon shift: per end effector, drop the fully past
    (stance, swing) cycles and extend the tail by repeating the last
    cycle's durations."""
    b = sched.bounds
    P = b.shape[-1] - 1
    cyc_ends = b[..., 2::2]
    n_past = torch.sum(cyc_ends <= _t_rows(t0), dim=-1)
    shift = 2 * n_past
    idx = torch.arange(P + 1, device=b.device) + shift[..., None]
    overflow = idx > P
    gathered = torch.gather(b, -1, torch.clamp(idx, 0, P))
    sd = b[..., -2:-1] - b[..., -3:-2]                 # last stance duration
    wd = b[..., -1:] - b[..., -2:-1]                   # last swing duration
    k = (idx - P).to(b.dtype)
    extra = torch.ceil(k / 2) * sd + torch.floor(k / 2) * wd
    return GaitSchedule(bounds=torch.where(overflow, b[..., -1:] + extra,
                                           gathered))


def roll_spline_vars(f_nodes: torch.Tensor, footholds: torch.Tensor,
                     n_past: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift per-stance-slot variables in lockstep with the window.

    f_nodes [..., E, S, F-1, 3, 2]; footholds [..., E, S+1, 2]; n_past
    [..., E].  New tail slots repeat the last in-window slot."""
    S = f_nodes.shape[-4]
    idx_f = torch.clamp(torch.arange(S, device=n_past.device)
                        + n_past[..., None], 0, S - 1)
    f_new = torch.gather(f_nodes, -4, idx_f[..., None, None, None].expand(
        *idx_f.shape, *f_nodes.shape[-3:]))
    Sp1 = footholds.shape[-2]
    idx_p = torch.clamp(torch.arange(Sp1, device=n_past.device)
                        + n_past[..., None], 0, Sp1 - 1)
    p_new = torch.gather(footholds, -2, idx_p[..., None].expand(
        *idx_p.shape, footholds.shape[-1]))
    return f_new, p_new


def past_cycles(sched: GaitSchedule, t0: torch.Tensor) -> torch.Tensor:
    """[..., E] number of fully past (stance, swing) cycles."""
    return torch.sum(sched.bounds[..., 2::2] <= _t_rows(t0), dim=-1)


# ----------------------------------------------------------------------------
# Closed-loop fixups; ``measured`` [..., E] bool, ``t`` [...]
# ----------------------------------------------------------------------------

def adjust_for_current_contacts(sched: GaitSchedule, measured: torch.Tensor,
                                t: torch.Tensor,
                                window: float = 7e-2) -> GaitSchedule:
    """Early-touchdown fixup: feet that measure contact while still scheduled
    for swing, within ``window`` seconds of their planned touchdown, get the
    touchdown snapped to now."""
    desired = contact_flags(sched, t)
    next_td = next_touchdown_time(sched.bounds, t[..., None])
    mask = measured & ~desired & ((next_td - t[..., None]) < window)
    return set_ee_in_contact(sched, mask, t)


def set_ee_in_contact(sched: GaitSchedule, ee_mask: torch.Tensor,
                      t: torch.Tensor) -> GaitSchedule:
    """Pull the next touchdown of the feet in ``ee_mask`` [..., E] back to
    time t, keeping each row nondecreasing."""
    b = sched.bounds
    P1 = b.shape[-1]
    tt = _t_rows(t).to(b.dtype)
    cols = torch.arange(P1, device=b.device)
    is_td = cols % 2 == 0
    cand = torch.where(is_td & (b > tt), b, b[..., -1:] + 1e6)
    td_col = torch.argmin(cand, dim=-1)                        # [..., E]
    onehot = (cols == td_col[..., None]).to(b.dtype)
    mask = ee_mask[..., None]
    new_b = torch.where(mask, b * (1 - onehot) + tt * onehot, b)
    # boundaries before the moved one must not exceed it
    inf = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    cap = torch.where(cols <= td_col[..., None], tt + 0.0 * new_b, inf)
    new_b = torch.minimum(new_b, cap)
    return GaitSchedule(bounds=torch.where(mask, new_b, b))
