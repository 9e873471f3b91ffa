"""Bilevel gait optimization, batch first (port of ``outer_gradient_at``,
``contact_time_step``, ``_lane_search`` and ``gait_opt_update`` of
``bilevel_gait_gen_tpu/mpc/bilevel.py``; the rationale of every policy is
documented there).

The outer gradient is the one place where autograd runs on the serving
path: ``torch.autograd.grad`` of the batch's summed QP objectives with
respect to the contact times, through ``qp.assemble`` and the IFT adjoint of
``pdip.solve_primal``.  The scenarios are independent, so the sum gives each
its own gradient.  The alpha lanes of the line search flatten to
B * ls_alphas problems of one batched solve.  BFGS curvature
(``cfg.gait_bfgs``), ``line_search`` and ``outer_gradient`` are not ported
yet.
"""
from __future__ import annotations

import dataclasses

import torch

from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc import qp as qp_mod
from bilevel_gait_gen_tpu_torch.mpc import solver as solver_mod
from bilevel_gait_gen_tpu_torch.mpc.gait import GaitSchedule
from bilevel_gait_gen_tpu_torch.mpc.trajectory import Trajectory
from bilevel_gait_gen_tpu_torch.ops import pdip
from bilevel_gait_gen_tpu_torch.utils.precision import set_fp32_precision
from bilevel_gait_gen_tpu.utils.config import MPCConfig


def qp_objective(qp: qp_mod.CondensedQP, u: torch.Tensor) -> torch.Tensor:
    """0.5 u^T H u + q^T u + const, per scenario [B]."""
    Hu = pdip._mv(qp.H, u)
    return (0.5 * torch.sum(u * Hu, dim=-1) + torch.sum(qp.q * u, dim=-1)
            + qp.cost_const)


def outer_gradient_at(cfg: MPCConfig, params: SRBParams,
                      traj_lin: Trajectory, x0_man: torch.Tensor,
                      t0: torch.Tensor, ee_pos0: torch.Tensor,
                      x_des_tan: torch.Tensor, ee_box: torch.Tensor,
                      sol: pdip.QPSolution) -> torch.Tensor:
    """dH/dtheta [B, E, P+1] at a captured production solution ``sol``,
    after ``cfg.ipm_grad_polish`` warm polish sweeps."""
    opts = (("iters", cfg.ipm_grad_polish), ("tol", cfg.ipm_tol),
            ("exact_every", 1), ("inverse", cfg.ipm_inverse))
    bounds = traj_lin.sched.bounds.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        traj_b = dataclasses.replace(traj_lin,
                                     sched=GaitSchedule(bounds=bounds))
        qp = qp_mod.assemble(cfg, params, traj_b, x0_man, t0, ee_pos0,
                             x_des_tan, ee_box)
        u = pdip.solve_primal(qp.H, qp.q, qp.A, qp.b, qp.G, qp.h, opts, sol)
        (g,) = torch.autograd.grad(qp_objective(qp, u).sum(), bounds)
    return g


def contact_time_step(cfg: MPCConfig, sched: GaitSchedule, grad: torch.Tensor,
                      t0: torch.Tensor,
                      trust: torch.Tensor | float | None = None) -> torch.Tensor:
    """Projected descent step on the contact times [B, E, P+1]: the small
    projection QP (ordering/dwell polytope, pinned past and imminent
    boundaries, infinity-norm trust region) on the unrolled IPM path."""
    b = sched.bounds
    B, E, P1 = b.shape
    n = E * P1
    dtype, dev = b.dtype, b.device
    g = grad.reshape(B, -1)
    c_scale = torch.clamp_min(torch.amax(torch.abs(g), dim=-1), 1.0)
    g = g / c_scale[:, None]
    trust = torch.as_tensor(cfg.trust_region if trust is None else trust,
                            dtype=dtype, device=dev).expand(B)

    past = b <= t0[:, None, None]
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    first_future = torch.argmin(torch.where(past, inf, b), dim=-1)   # [B, E]
    cols = torch.arange(P1, device=dev)
    imminent = ((cols >= first_future[..., None])
                & (cols < first_future[..., None] + cfg.gait_freeze_boundaries))
    pinned = (past | imminent).reshape(B, n)

    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    H = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n)
    q = torch.where(pinned, zero, g)
    A = torch.diag_embed(torch.where(pinned, one, zero))
    beq = torch.zeros(B, n, dtype=dtype, device=dev)

    # dwell polytope per EE: d_i - d_{i+1} <= (b_{i+1} - b_i) - min_dwell
    rows = [e * P1 + i for e in range(E) for i in range(P1 - 1)]
    G_ord = torch.zeros(len(rows), n, dtype=dtype, device=dev)
    r_idx = torch.arange(len(rows), device=dev)
    c_idx = torch.tensor(rows, device=dev)
    G_ord[r_idx, c_idx] = 1.0
    G_ord[r_idx, c_idx + 1] = -1.0
    gap = (b[..., 1:] - b[..., :-1]).reshape(B, -1)
    nxt_pinned = pinned.reshape(B, E, P1)[..., 1:].reshape(B, -1)
    dwell = torch.where(nxt_pinned, zero, cfg.min_dwell * one)
    h_ord = gap - torch.minimum(dwell, gap)
    eye = torch.eye(n, dtype=dtype, device=dev)
    G = torch.cat([G_ord, eye, -eye]).expand(B, -1, n)
    h = torch.cat([h_ord, trust[:, None].expand(B, 2 * n)], dim=-1)

    sol = pdip.solve(H, q, A, beq, G, h, iters=cfg.proj_iters, tol=1e-10)
    tr = trust[:, None]
    d = torch.minimum(torch.maximum(sol.x, -tr), tr)
    d = torch.where(pinned, zero, d)
    ok = (sol.pri_res < 1e-2) & torch.isfinite(d).all(-1)
    d = torch.where(ok[:, None], d, zero)
    b2 = torch.cummax(b + d.reshape(B, E, P1), dim=-1).values
    return b2 - b


def _lane_search(cfg: MPCConfig, params: SRBParams,
                 st1: solver_mod.SolverState, step: torch.Tensor,
                 x0_man: torch.Tensor, t0: torch.Tensor,
                 ee_pos0: torch.Tensor, x_des_tan: torch.Tensor):
    """Line-search lanes: alpha in {i / (LS - 1)}, alpha = 0 included, each
    an assemble + cold ``ls_ipm_iters``-sweep solve.  The B x LS lanes run
    as one batch.  Returns (win_alpha, win_obj, obj0), each per scenario
    (the JAX function also returns the winner's solution, which
    gait_opt_update does not use)."""
    LS = cfg.ls_alphas
    B = x0_man.shape[0]
    dtype, dev = x0_man.dtype, x0_man.device
    alphas = torch.arange(LS, dtype=dtype, device=dev) / float(max(LS - 1, 1))
    iters = cfg.ls_ipm_iters or cfg.ipm_iters

    def lanes(t):
        return torch.repeat_interleave(t, LS, dim=0)

    bounds_a = (st1.traj.sched.bounds[:, None]
                + alphas[None, :, None, None] * step[:, None])
    traj_a = Trajectory(x_man=lanes(st1.traj.x_man),
                        f_nodes=lanes(st1.traj.f_nodes),
                        footholds=lanes(st1.traj.footholds),
                        sched=GaitSchedule(bounds=bounds_a.reshape(
                            B * LS, *step.shape[1:])))
    qp = qp_mod.assemble(cfg, params, traj_a, lanes(x0_man), lanes(t0),
                         lanes(ee_pos0), lanes(x_des_tan), lanes(st1.ee_box))
    sol = pdip.solve(qp.H, qp.q, qp.A, qp.b, qp.G, qp.h, iters=iters,
                     tol=cfg.ipm_tol, exact_every=cfg.ls_exact_every,
                     inverse=cfg.ipm_inverse)
    obj = qp_objective(qp, sol.x)
    scale = 1.0 + torch.maximum(torch.amax(torch.abs(qp.q), dim=-1),
                                torch.abs(obj))
    good = ((sol.gap < 1e-3 * scale) & (sol.pri_res < 1e-3 * scale)
            & torch.isfinite(sol.x).all(-1))
    objs = torch.where(good, obj, torch.full_like(obj, float("inf")))
    objs = objs.reshape(B, LS)
    best = torch.argmin(objs, dim=-1)
    return alphas[best], objs[torch.arange(B, device=dev), best], objs[:, 0]


@dataclasses.dataclass(frozen=True)
class GaitOptResult:
    state: solver_mod.SolverState
    alpha: torch.Tensor          # [B] accepted step (0 on rejection)
    cost: torch.Tensor           # [B]
    grad_norm: torch.Tensor      # [B]
    cost0: torch.Tensor          # [B] objective of the alpha = 0 lane
    trust: torch.Tensor          # [B] radius for the next outer step
    accepted: torch.Tensor       # [B] bool
    rti_stats: solver_mod.SolveStats
    rti_obj: torch.Tensor        # [B] embedded RTI's QP objective
    win_obj: torch.Tensor        # [B] winning lane's QP objective


def gait_opt_update(cfg: MPCConfig, params: SRBParams,
                    state: solver_mod.SolverState, x0_man: torch.Tensor,
                    t0: torch.Tensor, ee_pos0: torch.Tensor,
                    x_des_tan: torch.Tensor,
                    trust: torch.Tensor | float | None = None
                    ) -> GaitOptResult:
    """One full bilevel update for B scenarios, replacing one inner RTI:
    production solve (captured) -> IFT gradient at that solution ->
    projection QP -> line-search lanes -> trust-region acceptance."""
    set_fp32_precision()
    if cfg.gait_bfgs:
        raise NotImplementedError("gait_bfgs is not ported yet")
    dtype, dev = x0_man.dtype, x0_man.device
    B = x0_man.shape[0]
    trust_in = torch.as_tensor(cfg.trust_region if trust is None else trust,
                               dtype=dtype, device=dev).expand(B)

    st1, stats, ext = solver_mod.solve_step(cfg, params, state, x0_man, t0,
                                            ee_pos0, x_des_tan,
                                            return_ext=True)
    g = outer_gradient_at(cfg, params, ext.traj_lin, x0_man, t0, ee_pos0,
                          x_des_tan, state.ee_box, ext.sol)
    g_ok = stats.solved & torch.isfinite(g).all(-1).all(-1)
    g = torch.where(g_ok[:, None, None], g, torch.zeros_like(g))

    d = contact_time_step(cfg, st1.traj.sched, g, t0, trust=trust_in)
    win_alpha, win_obj, cost0 = _lane_search(
        cfg, params, st1, d, x0_man, t0, ee_pos0, x_des_tan)

    # ratio test on the linear model, with g scaled as the projection QP
    # scaled it
    g_n = g / torch.clamp_min(torch.amax(torch.abs(g), dim=(-1, -2)),
                              1.0)[:, None, None]
    pred = -win_alpha * torch.sum(g_n * d, dim=(-1, -2))
    actual = cost0 - win_obj
    tiny = 100 * torch.finfo(dtype).eps
    ratio = actual / torch.clamp_min(pred, tiny)
    rti_obj = qp_objective(ext.qp, ext.sol.x)
    rti_obj = torch.where(stats.solved, rti_obj,
                          torch.full_like(rti_obj, float("inf")))
    took_step = (torch.isfinite(win_obj) & (win_obj < cost0)
                 & (win_obj < rti_obj))
    accepted = took_step & (pred > tiny) & (ratio >= cfg.tr_eta_low)

    bounds_new = torch.where(accepted[:, None, None],
                             st1.traj.sched.bounds + win_alpha[:, None, None] * d,
                             st1.traj.sched.bounds)
    traj_new = dataclasses.replace(st1.traj,
                                   sched=GaitSchedule(bounds=bounds_new))
    # the embedded RTI's full-depth solution stays the next warm start
    new_state = solver_mod.SolverState(traj=traj_new, ee_box=st1.ee_box,
                                       qp_warm=st1.qp_warm)

    grow = accepted & (ratio >= cfg.tr_eta_high)
    trust_new = torch.where(
        grow, torch.clamp_max(trust_in * cfg.tr_grow, cfg.trust_region),
        torch.where(accepted, trust_in,
                    torch.clamp_min(trust_in * cfg.tr_shrink, cfg.tr_min)))
    zero = torch.zeros((), dtype=dtype, device=dev)
    return GaitOptResult(
        state=new_state, alpha=torch.where(accepted, win_alpha, zero),
        cost=torch.where(accepted, win_obj, cost0),
        grad_norm=torch.linalg.vector_norm(d, dim=(-1, -2)), cost0=cost0,
        trust=trust_new, accepted=accepted, rti_stats=stats,
        rti_obj=rti_obj, win_obj=win_obj)
