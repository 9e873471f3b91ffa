"""Bilevel gait optimization, batch first (port of
``bilevel_gait_gen_tpu/mpc/bilevel.py``; the rationale of every policy is
documented there).

The outer gradient is the one place where autograd runs on the serving
path: ``torch.autograd.grad`` of the batch's summed QP objectives with
respect to the contact times, through ``qp.assemble`` and the IFT adjoint of
``pdip.solve_primal``.  The scenarios are independent, so the sum gives each
its own gradient.  The alpha lanes of the line search flatten to
B * ls_alphas problems of one batched solve.
"""
from __future__ import annotations

import dataclasses

import torch

from .srb import SRBParams
from . import qp as qp_mod
from . import solver as solver_mod
from .gait import GaitSchedule
from .trajectory import Trajectory
from . import pdip
from .config import MPCConfig
from .consts import filled


def qp_objective(qp: qp_mod.CondensedQP, u: torch.Tensor) -> torch.Tensor:
    """0.5 u^T H u + q^T u + const, per scenario [B]."""
    Hu = pdip._mv(qp.H, u)
    return (0.5 * torch.sum(u * Hu, dim=-1) + torch.sum(qp.q * u, dim=-1)
            + qp.cost_const)


def _grad_wrt_bounds(cfg, params, traj, x0_man, t0, ee_pos0, x_des_tan,
                     ee_box, opts, warm) -> torch.Tensor:
    """d(sum of QP objectives)/d(bounds) through assemble and the IFT
    adjoint of ``pdip.solve_primal``."""
    bounds = traj.sched.bounds.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        traj_b = dataclasses.replace(traj, sched=GaitSchedule(bounds=bounds))
        qp = qp_mod.assemble(cfg, params, traj_b, x0_man, t0, ee_pos0,
                             x_des_tan, ee_box)
        u = pdip.solve_primal(qp.H, qp.q, qp.A, qp.b, qp.G, qp.h, opts, warm)
        (g,) = torch.autograd.grad(qp_objective(qp, u).sum(), bounds)
    return g


def outer_gradient_at(cfg: MPCConfig, params: SRBParams,
                      traj_lin: Trajectory, x0_man: torch.Tensor,
                      t0: torch.Tensor, ee_pos0: torch.Tensor,
                      x_des_tan: torch.Tensor, ee_box: torch.Tensor,
                      sol: pdip.QPSolution) -> torch.Tensor:
    """dH/dtheta [B, E, P+1] at a captured production solution ``sol``,
    after ``cfg.ipm_grad_polish`` warm polish sweeps."""
    opts = (("iters", cfg.ipm_grad_polish), ("tol", cfg.ipm_tol),
            ("exact_every", 1), ("inverse", cfg.ipm_inverse))
    return _grad_wrt_bounds(cfg, params, traj_lin, x0_man, t0, ee_pos0,
                            x_des_tan, ee_box, opts, sol)


def contact_time_step(cfg: MPCConfig, sched: GaitSchedule, grad: torch.Tensor,
                      t0: torch.Tensor,
                      trust: torch.Tensor | float | None = None,
                      Bk: torch.Tensor | None = None) -> torch.Tensor:
    """Projected descent step on the contact times [B, E, P+1]: the small
    projection QP  min g.d + d.(I + Bk).d / 2  (ordering/dwell polytope,
    pinned past and imminent boundaries, infinity-norm trust region) on the
    unrolled IPM path.  ``Bk`` [B, n, n] is the damped-BFGS outer curvature
    (``cfg.gait_bfgs``), scaled by the same factor as the gradient."""
    b = sched.bounds
    B, E, P1 = b.shape
    n = E * P1
    dtype, dev = b.dtype, b.device
    g = grad.reshape(B, -1)
    c_scale = torch.clamp_min(torch.amax(torch.abs(g), dim=-1), 1.0)
    g = g / c_scale[:, None]
    trust = filled(cfg.trust_region if trust is None else trust, (B,),
                   dtype, dev)

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
    if Bk is not None:
        H = H + Bk / c_scale[:, None, None]
    q = torch.where(pinned, zero, g)
    A = torch.diag_embed(torch.where(pinned, one, zero))
    beq = torch.zeros(B, n, dtype=dtype, device=dev)

    # dwell polytope per EE: d_i - d_{i+1} <= (b_{i+1} - b_i) - min_dwell
    # row r = e (P1 - 1) + i: +1 at column e P1 + i, -1 at the next
    r_idx = torch.arange(E * (P1 - 1), device=dev)
    c_idx = (r_idx + torch.div(r_idx, P1 - 1, rounding_mode="floor"))[:, None]
    cols_n = torch.arange(n, device=dev)
    G_ord = ((cols_n == c_idx).to(dtype) - (cols_n == c_idx + 1).to(dtype))
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


@dataclasses.dataclass(frozen=True)
class OuterCurvature:
    """Damped-BFGS curvature of the outer objective, carried across gait
    ticks: B [B, n, n] (n = E * (P+1) flattened bounds), theta [B, n] the
    bounds at which g [B, n] was evaluated, ok [B] whether that pair exists
    and the bounds array has not been re-indexed since."""
    B: torch.Tensor
    theta: torch.Tensor
    g: torch.Tensor
    ok: torch.Tensor


def _bfgs_update(B: torch.Tensor, s: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """One Powell-damped BFGS update per scenario,
    B <- B - B s s^T B / s^T B s + y y^T / s^T y, with y blended toward B s
    when s^T y < 0.2 s^T B s; degenerate pairs leave B unchanged.
    B [B, n, n], s and y [B, n]."""
    Bs = pdip._mv(B, s)
    sBs = torch.sum(s * Bs, dim=-1)
    sy = torch.sum(s * y, dim=-1)
    tau = torch.where(sy < 0.2 * sBs,
                      0.8 * sBs / torch.clamp_min(sBs - sy, 1e-12),
                      torch.ones_like(sy))
    y_d = tau[:, None] * y + (1.0 - tau)[:, None] * Bs
    sy_d = torch.sum(s * y_d, dim=-1)
    upd = (B
           - ((sBs > 1e-12).to(B.dtype) / torch.clamp_min(sBs, 1e-12)
              )[:, None, None] * (Bs[:, :, None] * Bs[:, None, :])
           + (y_d[:, :, None] * y_d[:, None, :])
           / torch.clamp_min(sy_d, 1e-12)[:, None, None])
    good = ((torch.sum(s * s, dim=-1) > 1e-12) & (sy_d > 1e-12)
            & torch.isfinite(upd).all(-1).all(-1))
    return torch.where(good[:, None, None], upd, B)


def _lane_search(cfg: MPCConfig, params: SRBParams,
                 st1: solver_mod.SolverState, step: torch.Tensor,
                 x0_man: torch.Tensor, t0: torch.Tensor,
                 ee_pos0: torch.Tensor, x_des_tan: torch.Tensor,
                 ):
    """Line-search lanes: alpha in {i / (LS - 1)}, alpha = 0 included, each
    an assemble + cold ``ls_ipm_iters``-sweep solve.  The B x LS lanes run
    as one batch.  Returns (win_alpha, win_obj, obj0), each per scenario
    (the JAX function also returns the winner's solution, which
    gait_opt_update does not use).
"""
    LS = cfg.ls_alphas
    B = x0_man.shape[0]
    dtype, dev = x0_man.dtype, x0_man.device
    denom = float(max(LS - 1, 1))
    lane0, per = 0, LS
    alphas = torch.arange(lane0, lane0 + per, dtype=dtype, device=dev) / denom
    objs = _lane_objectives(cfg, params, st1, step, x0_man, t0, ee_pos0,
                            x_des_tan, alphas)
    best = torch.argmin(objs, dim=-1)
    return alphas[best], objs[torch.arange(B, device=dev), best], objs[:, 0]


def _lane_objectives(cfg: MPCConfig, params: SRBParams,
                     st1: solver_mod.SolverState, step: torch.Tensor,
                     x0_man: torch.Tensor, t0: torch.Tensor,
                     ee_pos0: torch.Tensor, x_des_tan: torch.Tensor,
                     alphas: torch.Tensor) -> torch.Tensor:
    """The lanes' QP objectives [B, len(alphas)], inf where a lane's solve
    fails the quality gate."""
    LS = alphas.shape[0]
    B = x0_man.shape[0]
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
    return objs.reshape(B, LS)


@dataclasses.dataclass(frozen=True)
class GaitOptResult:
    state: solver_mod.SolverState
    alpha: torch.Tensor          # [B] accepted step (0 on rejection)
    cost: torch.Tensor           # [B]
    grad_norm: torch.Tensor      # [B]
    cost0: torch.Tensor          # [B] objective of the alpha = 0 lane
    trust: torch.Tensor          # [B] radius for the next outer step
    accepted: torch.Tensor       # [B] bool
    # filled by gait_opt_update; None from a plain line_search
    rti_stats: solver_mod.SolveStats | None = None
    rti_obj: torch.Tensor | None = None   # [B] embedded RTI's QP objective
    win_obj: torch.Tensor | None = None   # [B] winning lane's QP objective
    curv: OuterCurvature | None = None    # BFGS carry (cfg.gait_bfgs)


def gait_opt_update(cfg: MPCConfig, params: SRBParams,
                    state: solver_mod.SolverState, x0_man: torch.Tensor,
                    t0: torch.Tensor, ee_pos0: torch.Tensor,
                    x_des_tan: torch.Tensor,
                    trust: torch.Tensor | float | None = None,
                    curv: OuterCurvature | None = None) -> GaitOptResult:
    """One full bilevel update for B scenarios, replacing one inner RTI:
    production solve (captured) -> IFT gradient at that solution ->
    projection QP -> line-search lanes -> trust-region acceptance.  With
    ``cfg.gait_bfgs`` and a ``curv`` carry (pass ``res.curv`` back in), the
    projection QP and the ratio test use the damped-BFGS quadratic model;
    the carry resets when the bounds array was re-indexed between ticks."""
    dtype, dev = x0_man.dtype, x0_man.device
    B = x0_man.shape[0]
    trust_in = filled(cfg.trust_region if trust is None else trust, (B,),
                      dtype, dev)

    st1, stats, ext = solver_mod.solve_step(cfg, params, state, x0_man, t0,
                                            ee_pos0, x_des_tan,
                                            return_ext=True)
    g = outer_gradient_at(cfg, params, ext.traj_lin, x0_man, t0, ee_pos0,
                          x_des_tan, state.ee_box, ext.sol)
    g_ok = stats.solved & torch.isfinite(g).all(-1).all(-1)
    g = torch.where(g_ok[:, None, None], g, torch.zeros_like(g))

    Bk = None
    theta_now = st1.traj.sched.bounds.reshape(B, -1)
    g_flat = g.reshape(B, -1)
    if cfg.gait_bfgs and curv is not None:
        # a window roll or flight hold re-indexes or translates the bounds
        # between ticks; the past boundary theta[:, 0] is pinned by the step
        # QP, so a change there flags it: the carried matrix is then in the
        # old slot frame and is reset to zero
        aligned = curv.ok & torch.all(
            torch.abs(curv.theta.reshape(st1.traj.sched.bounds.shape)[..., 0]
                      - st1.traj.sched.bounds[..., 0]) < 1e-6, dim=-1)
        Bk = torch.where(aligned[:, None, None],
                         _bfgs_update(curv.B, theta_now - curv.theta,
                                      g_flat - curv.g),
                         torch.zeros_like(curv.B))

    d = contact_time_step(cfg, st1.traj.sched, g, t0, trust=trust_in, Bk=Bk)
    win_alpha, win_obj, cost0 = _lane_search(
        cfg, params, st1, d, x0_man, t0, ee_pos0, x_des_tan)

    # ratio test on the linear model, with g scaled as the projection QP
    # scaled it
    g_n = g / torch.clamp_min(torch.amax(torch.abs(g), dim=(-1, -2)),
                              1.0)[:, None, None]
    pred = -win_alpha * torch.sum(g_n * d, dim=(-1, -2))
    if Bk is not None:
        # quadratic model: pred = -(a g_n.d + a^2 / 2 d.(Bk / c).d)
        c_sc = torch.clamp_min(torch.amax(torch.abs(g), dim=(-1, -2)), 1.0)
        df = d.reshape(B, -1)
        pred = pred - (0.5 * win_alpha ** 2
                       * torch.sum(df * pdip._mv(Bk, df), dim=-1) / c_sc)
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
    curv_new = None
    if cfg.gait_bfgs and curv is not None:
        # this tick's evaluation point: the next tick's (s, y) pair spans
        # consecutive gradient evaluations
        curv_new = OuterCurvature(
            B=Bk, theta=theta_now, g=g_flat,
            ok=stats.solved & torch.isfinite(g_flat).all(-1))
    zero = torch.zeros((), dtype=dtype, device=dev)
    return GaitOptResult(
        state=new_state, alpha=torch.where(accepted, win_alpha, zero),
        cost=torch.where(accepted, win_obj, cost0),
        grad_norm=torch.linalg.vector_norm(d, dim=(-1, -2)), cost0=cost0,
        trust=trust_new, accepted=accepted, rti_stats=stats,
        rti_obj=rti_obj, win_obj=win_obj, curv=curv_new)
