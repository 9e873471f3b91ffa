"""Contact-phase cubic-Hermite splines for forces and foot positions (port
of ``bilevel_gait_gen_tpu/ops/spline.py``; the semantics are documented
there).

The JAX functions take one end effector and a scalar time and are
``vmap``ped; here ``bounds`` is ``[..., P+1]`` and ``t`` any shape that
broadcasts against ``bounds.shape[:-1]``.  Everything stays differentiable in
``bounds``, with ``jnp``'s gradient conventions at ties
(``utils/jnp_compat.py``).
"""
from __future__ import annotations

import torch

from bilevel_gait_gen_tpu_torch.mpc.gait import phase_index
from bilevel_gait_gen_tpu_torch.utils import jnp_compat as jc

FORCE_MULT = 100.0
_EPS = 1e-8


def _hermite(x0, x1, d0, d1, dt, s):
    """Cubic Hermite value at local time s in [0, dt]."""
    dt = jc.maximum(dt, _EPS)
    a2 = -(3.0 * (x0 - x1)) / dt**2 - (2.0 * d0 + d1) / dt
    a3 = (2.0 * (x0 - x1)) / dt**3 + (d0 + d1) / dt**2
    return x0 + d0 * s + a2 * s * s + a3 * s * s * s


def force_value(bounds: torch.Tensor, f_nodes: torch.Tensor, t: torch.Tensor,
                num_force_polys: int) -> torch.Tensor:
    """Contact force [..., 3] of one end effector at time t.

    bounds [..., P+1]; f_nodes [..., S, F-1, 3, 2] interior stance nodes
    (value, scaled derivative)."""
    F = num_force_polys
    p = phase_index(bounds, t)
    is_stance = p % 2 == 0
    s_idx = torch.div(p, 2, rounding_mode="floor")
    t_lo = jc.take(bounds, p, -1)
    t_hi = jc.take(bounds, p + 1, -1)
    dur = jc.maximum(t_hi - t_lo, _EPS)
    seg_dt = dur / F
    j = torch.clamp(torch.floor((t - t_lo) / seg_dt).long(), 0, F - 1)
    s_local = t - (t_lo + j.to(t_lo.dtype) * seg_dt)

    nodes = jc.take(f_nodes, s_idx, -4)                       # [..., F-1, 3, 2]
    zero = torch.zeros((), dtype=f_nodes.dtype, device=f_nodes.device)
    left = torch.where((j == 0)[..., None, None], zero,
                       jc.take(nodes, torch.clamp(j - 1, min=0), -3))
    right = torch.where((j == F - 1)[..., None, None], zero,
                        jc.take(nodes, torch.clamp(j, max=F - 2), -3))
    val = _hermite(left[..., 0], right[..., 0],
                   FORCE_MULT * left[..., 1], FORCE_MULT * right[..., 1],
                   seg_dt[..., None], s_local[..., None])
    return torch.where(is_stance[..., None], val, zero)


def foot_position(bounds: torch.Tensor, footholds: torch.Tensor,
                  t: torch.Tensor, swing_height: float,
                  foot_offset: float) -> torch.Tensor:
    """World foot position [..., 3] of one end effector at time t.

    footholds [..., S+1, 2]: xy per stance slot plus the target past the
    last stance."""
    p = phase_index(bounds, t)
    is_stance = p % 2 == 0
    s_idx = torch.div(p, 2, rounding_mode="floor")
    xy_stance = jc.take(footholds, s_idx, -2)
    t_lo = jc.take(bounds, p, -1)
    dur = jc.maximum(jc.take(bounds, p + 1, -1) - t_lo, _EPS)
    tau = jc.clip((t - t_lo) / dur, 0.0, 1.0)
    blend = tau * tau * (3.0 - 2.0 * tau)
    xy_next = jc.take(footholds, torch.clamp(s_idx + 1,
                                          max=footholds.shape[-2] - 1), -2)
    xy_swing = xy_stance + blend[..., None] * (xy_next - xy_stance)
    xy = torch.where(is_stance[..., None], xy_stance, xy_swing)

    half = 0.5 * dur
    first_half = tau < 0.5
    s_loc = torch.where(first_half, t - t_lo, t - t_lo - half)
    z_swing = torch.where(
        first_half,
        _hermite(foot_offset, swing_height, 0.0, 0.0, half, s_loc),
        _hermite(swing_height, foot_offset, 0.0, 0.0, half, s_loc))
    z = torch.where(is_stance, torch.full_like(z_swing, foot_offset), z_swing)
    lead = torch.broadcast_shapes(xy.shape[:-1], z.shape)
    return torch.cat([xy.expand(*lead, 2), z.expand(lead)[..., None]], dim=-1)


# ----------------------------------------------------------------------------
# Dense basis weights (the closed-form assembly path)
# ----------------------------------------------------------------------------

def _hermite_basis(dt, s):
    """Cubic Hermite basis (h00, h01, h10, h11) at local time s in [0, dt]."""
    dt = jc.maximum(dt, _EPS)
    r2 = (s * s) / (dt * dt)
    r3 = (s * s * s) / (dt * dt * dt)
    h00 = 1.0 - 3.0 * r2 + 2.0 * r3
    h01 = 3.0 * r2 - 2.0 * r3
    h10 = s - 2.0 * s * s / dt + s * s * s / (dt * dt)
    h11 = -s * s / dt + s * s * s / (dt * dt)
    return h00, h01, h10, h11


def force_weights(bounds: torch.Tensor, t: torch.Tensor,
                  num_force_polys: int) -> torch.Tensor:
    """[..., S, F-1, 2] weights with force_coord(t) = sum w * f_nodes[..., c].

    Zero outside stance."""
    F = num_force_polys
    S = bounds.shape[-1] // 2
    t0 = bounds[..., 0:2 * S:2]
    t1 = bounds[..., 1:2 * S + 1:2]
    t = t[..., None]
    dur = jc.maximum(t1 - t0, _EPS)
    seg = dur / F
    active = (t >= t0) & (t < t1)                            # [..., S]
    j = torch.clamp(torch.floor((t - t0) / seg), 0, F - 1)   # float
    s_loc = t - (t0 + j * seg)
    h00, h01, h10, h11 = _hermite_basis(seg, s_loc)
    k = torch.arange(1, F, dtype=bounds.dtype, device=bounds.device)
    left = j[..., None] == k
    right = j[..., None] == k - 1.0
    zero = torch.zeros((), dtype=bounds.dtype, device=bounds.device)
    w_val = (torch.where(left, h00[..., None], zero)
             + torch.where(right, h01[..., None], zero))
    w_dot = (torch.where(left, h10[..., None], zero)
             + torch.where(right, h11[..., None], zero)) * FORCE_MULT
    w = torch.stack([w_val, w_dot], dim=-1)
    return w * active[..., None, None]


def foothold_weights(bounds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., S+1] weights with foot_xy(t) = sum w * footholds."""
    S = bounds.shape[-1] // 2
    t0 = bounds[..., 0:2 * S:2]
    t1 = bounds[..., 1:2 * S + 1:2]
    tt = t[..., None]
    stance_active = (tt >= t0) & (tt < t1)
    t0_next = torch.cat([t0[..., 1:], bounds[..., -1:]], dim=-1)
    swing_active = (tt >= t1) & (tt < t0_next)
    dur = jc.maximum(t0_next - t1, _EPS)
    tau = jc.clip((tt - t1) / dur, 0.0, 1.0)
    blend = tau * tau * (3.0 - 2.0 * tau)
    zero = torch.zeros((), dtype=bounds.dtype, device=bounds.device)
    head = (stance_active.to(bounds.dtype)
            + torch.where(swing_active, 1.0 - blend, zero))
    tail = torch.where(swing_active, blend, zero)
    pad = torch.zeros_like(head[..., :1])
    w = torch.cat([head, pad], dim=-1) + torch.cat([pad, tail], dim=-1)
    onehot = torch.zeros_like(w)
    first = onehot.clone()
    first[..., 0] = 1.0
    last = onehot
    last[..., -1] = 1.0
    before = tt < t0[..., :1]
    w = torch.where(before, first, w)
    after = tt >= bounds[..., -1:]
    return torch.where(after, last, w)


def foot_z_value(bounds: torch.Tensor, t: torch.Tensor, swing_height: float,
                 foot_offset: float) -> torch.Tensor:
    """Prescribed z profile [...] (not a decision variable)."""
    S = bounds.shape[-1] // 2
    t1 = bounds[..., 1:2 * S + 1:2]
    t0 = bounds[..., 0:2 * S:2]
    t0_next = torch.cat([t0[..., 1:], bounds[..., -1:]], dim=-1)
    tt = t[..., None]
    swing_active = (tt >= t1) & (tt < t0_next)
    dur = jc.maximum(t0_next - t1, _EPS)
    tau = jc.clip((tt - t1) / dur, 0.0, 1.0)
    half = 0.5 * dur
    first = tau < 0.5
    s_loc = torch.where(first, tt - t1, tt - t1 - half)
    z_sw = torch.where(
        first, _hermite(foot_offset, swing_height, 0.0, 0.0, half, s_loc),
        _hermite(swing_height, foot_offset, 0.0, 0.0, half, s_loc))
    zero = torch.zeros((), dtype=bounds.dtype, device=bounds.device)
    total = torch.sum(torch.where(swing_active, z_sw, zero), dim=-1)
    return torch.where(torch.any(swing_active, dim=-1), total,
                       torch.full_like(total, foot_offset))


def forces_all(sched_bounds: torch.Tensor, f_nodes: torch.Tensor,
               t: torch.Tensor, num_force_polys: int) -> torch.Tensor:
    """[..., E, 3] forces of all end effectors at time t [...]."""
    return force_value(sched_bounds, f_nodes, t[..., None], num_force_polys)


def carrier_weights(all_bounds: torch.Tensor, t: torch.Tensor,
                    ramp: float) -> torch.Tensor:
    """[..., E] normalized static-support weights (see the JAX docstring)."""
    S = all_bounds.shape[-1] // 2
    t0 = all_bounds[..., 0:2 * S:2]                     # [..., E, S]
    t1 = all_bounds[..., 1:2 * S + 1:2]
    dur = t1 - t0
    r = jc.minimum(jc.maximum(dur / 2, _EPS), ramp)
    big = 1e9
    nxt_swing = torch.cat([t0[..., 1:], t0[..., -1:] + big], dim=-1) - t1
    wd_tail = all_bounds[..., -1:] - all_bounds[..., -2:-1]
    prv_swing = t0 - torch.cat([t0[..., :1] - wd_tail, t1[..., :-1]], dim=-1)
    sw_eps = 1e-4
    tt = t[..., None, None]
    one = torch.ones((), dtype=all_bounds.dtype, device=all_bounds.device)
    inside = (tt >= t0) & (tt < t1)
    up = torch.where(prv_swing > sw_eps, jc.clip((tt - t0) / r, 0.0, 1.0), one)
    down = torch.where(nxt_swing > sw_eps, jc.clip((t1 - tt) / r, 0.0, 1.0),
                       one)
    w = torch.sum(inside * up * down * (dur > _EPS), dim=-1)
    return w / jc.maximum(torch.sum(w, dim=-1, keepdim=True), 1e-3)


def carrier_forces(all_bounds: torch.Tensor, t: torch.Tensor, total_weight,
                   ramp: float) -> torch.Tensor:
    """[..., E, 3] static-support carrier forces (z only)."""
    w = carrier_weights(all_bounds, t, ramp) * total_weight
    zero = torch.zeros_like(w)
    return torch.stack([zero, zero, w], dim=-1)


def foot_positions_all(sched_bounds: torch.Tensor, footholds: torch.Tensor,
                       t: torch.Tensor, swing_height: float,
                       foot_offset: float) -> torch.Tensor:
    """[..., E, 3] foot positions of all end effectors at time t [...]."""
    return foot_position(sched_bounds, footholds, t[..., None], swing_height,
                         foot_offset)
