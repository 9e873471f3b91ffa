"""SQP real-time iteration, batch first (port of
``bilevel_gait_gen_tpu/mpc/solver.py``; the rationale of every policy below
is documented there).

One call of :func:`solve_step` advances B scenarios: shift the receding
window, assemble the condensed QP around the previous trajectory, solve it
with the interior-point method, run the merit line search and the quality
gate, update the trajectory and carry the warm start.  ``create_initial_run``
and the ``admm`` backend are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from bilevel_gait_gen_tpu_torch.models import srb
from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc import gait as gait_mod
from bilevel_gait_gen_tpu_torch.mpc import qp as qp_mod
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (Trajectory,
                                                       make_unravel, ravel_u)
from bilevel_gait_gen_tpu_torch.ops import pdip
from bilevel_gait_gen_tpu_torch.utils.precision import set_fp32_precision
from bilevel_gait_gen_tpu.utils.config import MPCConfig


@dataclasses.dataclass(frozen=True)
class SolverState:
    traj: Trajectory
    ee_box: torch.Tensor                   # [B, 2] adaptive EE box
    qp_warm: pdip.QPSolution | None = None  # IPM warm start; None = cold


def make_state(cfg: MPCConfig, traj: Trajectory,
               ee_box: torch.Tensor) -> SolverState:
    """Solver state for B scenarios (ee_box [B, 2]) carrying the IPM warm
    start, which starts from the gap = inf "never solved" sentinel."""
    dtype, dev = ee_box.dtype, ee_box.device
    B = ee_box.shape[0]
    E, S, FB, N = (cfg.num_ee, cfg.num_stance_slots, cfg.samples_per_stance,
                   cfg.num_nodes)
    p = 4 * E
    if cfg.raibert:
        p += E * (cfg.num_phase_slots // 2 + 1) * 2
    m = E * S * FB * 4 + 2 * E * S * FB + 2 * (N + 1 - cfg.ee_node_start) * E * 2

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=dev)

    neutral = pdip.QPSolution(
        x=full((B, cfg.num_u), 0.0), y=full((B, p), 0.0),
        lam=full((B, m), 1.0), s=full((B, m), 1.0),
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        gap=full((B,), float("inf")), pri_res=full((B,), 1.0),
        dua_res=full((B,), 1.0))
    return SolverState(traj=traj, ee_box=ee_box, qp_warm=neutral)


@dataclasses.dataclass(frozen=True)
class SolveExt:
    """The assembled QP, its solution and the linearization trajectory of
    one RTI, captured for the bilevel gradient."""
    qp: qp_mod.CondensedQP
    sol: pdip.QPSolution
    traj_lin: Trajectory


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Per-scenario stats of one RTI, each [B]."""
    cost: torch.Tensor
    merit: torch.Tensor
    defect_l1: torch.Tensor
    step_norm: torch.Tensor
    alpha: torch.Tensor
    qp_gap: torch.Tensor
    qp_pri: torch.Tensor
    qp_dua: torch.Tensor
    solved: torch.Tensor


def _defect_l1(cfg: MPCConfig, params: SRBParams, xs_tan: torch.Tensor,
               f_nodes, footholds, bounds, t0) -> torch.Tensor:
    """L1 norm of the nonlinear Euler-integration defects.

    xs_tan [..., N+1, 12], f_nodes [..., E, S, F-1, 3, 2], footholds
    [..., E, S+1, 2], bounds [..., E, P+1], t0 [...] -> [...]."""
    N, dt = cfg.num_nodes, cfg.dt
    times = t0[..., None] + dt * torch.arange(N, dtype=xs_tan.dtype,
                                              device=xs_tan.device)
    x_next = srb.discrete_step(params, xs_tan[..., :N, :],
                               f_nodes[..., None, :, :, :, :, :],
                               footholds[..., None, :, :, :],
                               bounds[..., None, :, :], times, dt, cfg)
    return torch.sum(torch.abs(xs_tan[..., 1:, :] - x_next), dim=(-1, -2))


def _roll_warm(cfg: MPCConfig, warm: pdip.QPSolution,
               n_past: torch.Tensor) -> pdip.QPSolution:
    """Shift the carried warm start's primal in lockstep with the window
    roll (the duals stay, see the JAX docstring)."""
    fn, fh = make_unravel(cfg)(warm.x)
    fn2, fh2 = gait_mod.roll_spline_vars(fn, fh, n_past)
    return dataclasses.replace(warm, x=ravel_u(fn2, fh2))


def solve_step(cfg: MPCConfig, params: SRBParams, state: SolverState,
               x0_man: torch.Tensor, t0: torch.Tensor, ee_pos0: torch.Tensor,
               x_des_tan: torch.Tensor, shift_window: bool = True,
               return_ext: bool = False):
    """One real-time iteration for B scenarios.

    x0_man [B, 13], t0 [B], ee_pos0 [B, E, 3], x_des_tan [B, 12].  Returns
    (state, stats), or (state, stats, SolveExt) with ``return_ext``."""
    set_fp32_precision()
    if cfg.qp_backend != "pdip":
        raise NotImplementedError(f"qp_backend={cfg.qp_backend!r} is not "
                                  "ported yet")
    traj = state.traj
    unravel = make_unravel(cfg)
    dtype, dev = x0_man.dtype, x0_man.device

    # ------- receding-horizon shift ---------------------------------------
    if shift_window:
        n_past = gait_mod.past_cycles(traj.sched, t0)
        sched = gait_mod.advance_window(traj.sched, t0, cfg)
        f_nodes, footholds = gait_mod.roll_spline_vars(
            traj.f_nodes, traj.footholds, n_past)
        traj = Trajectory(x_man=traj.x_man, f_nodes=f_nodes,
                          footholds=footholds, sched=sched)
        if cfg.warm_roll and state.qp_warm is not None:
            state = dataclasses.replace(
                state, qp_warm=_roll_warm(cfg, state.qp_warm, n_past))

    # ------- assemble + solve ---------------------------------------------
    qp = qp_mod.assemble(cfg, params, traj, x0_man, t0, ee_pos0, x_des_tan,
                         state.ee_box)
    exact_every = cfg.ipm_exact_every if state.qp_warm is not None else 1
    sol = pdip.solve(qp.H, qp.q, qp.A, qp.b, qp.G, qp.h,
                     iters=cfg.ipm_iters, tol=cfg.ipm_tol,
                     exact_every=exact_every,
                     use_pallas=None if cfg.qp_kernel == "pallas" else False,
                     inverse=cfg.ipm_inverse, warm=state.qp_warm)

    u_prev = ravel_u(traj.f_nodes, traj.footholds)               # [B, n_u]
    xs_prev = srb.manifold_to_tangent(traj.x_man)                # [B, N+1, 12]
    u_star = sol.x
    xs_star = qp_mod.recover_states(qp, u_star)
    p_u = u_star - u_prev
    p_x = xs_star - xs_prev

    # ------- merit line search: alpha = 0 and the halving grid at once ----
    mu = cfg.merit_mu
    alphas = 0.5 ** torch.arange(cfg.max_ls_iters + 1, dtype=dtype,
                                 device=dev)
    a_all = torch.cat([torch.zeros(1, dtype=dtype, device=dev), alphas])
    u_a = u_prev[:, None, :] + a_all[None, :, None] * p_u[:, None, :]
    xs_a = (xs_prev[:, None] + a_all[None, :, None, None] * p_x[:, None])
    fn_a, fh_a = unravel(u_a)
    defects_all = _defect_l1(cfg, params, xs_a, fn_a, fh_a,
                             traj.sched.bounds[:, None], t0[:, None])
    costs_all = qp_mod.cost_value(cfg, xs_a, u_a, x_des_tan[:, None, :])
    merits_all = mu * defects_all + costs_all
    merit0, defect0, cost0 = (merits_all[:, 0], defects_all[:, 0],
                              costs_all[:, 0])
    merits, defects, costs = (merits_all[:, 1:], defects_all[:, 1:],
                              costs_all[:, 1:])

    # solve quality gate, scaled by the objective magnitude
    scale = 1.0 + torch.maximum(torch.amax(torch.abs(qp.q), dim=-1),
                                torch.abs(cost0))
    good = ((sol.gap < 1e-3 * scale) & (sol.pri_res < 1e-3 * scale)
            & torch.isfinite(u_star).all(-1))

    grad_cost = pdip._mv(qp.H, u_prev) + qp.q
    dir_deriv = torch.sum(grad_cost * p_u, dim=-1) - mu * defect0
    armijo_ok = (merit0[:, None] - merits) >= -1e-5 * alphas * dir_deriv[:, None]
    # largest alpha passing Armijo; none passing rejects the step
    first_ok = torch.argmax(armijo_ok.to(torch.int32), dim=-1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    alpha = torch.where(armijo_ok.any(-1), alphas[first_ok], zero)
    alpha = torch.where(good, alpha, zero)

    # ------- update (explicit select: a rejected solve's NaN direction must
    # not leak through 0 * NaN) ---------------------------------------------
    u_new = torch.where(good[:, None], u_prev + alpha[:, None] * p_u, u_prev)
    xs_new = torch.where(good[:, None, None],
                         xs_prev + alpha[:, None, None] * p_x, xs_prev)
    fn_new, fh_new = unravel(u_new)
    traj_new = Trajectory(x_man=srb.tangent_to_manifold(xs_new),
                          f_nodes=fn_new, footholds=fh_new, sched=traj.sched)

    # ------- EE-box relaxation ladder -------------------------------------
    nominal = torch.tensor(cfg.ee_box_size, dtype=dtype, device=dev)
    ee_box = torch.where(good[:, None],
                         torch.maximum(nominal, state.ee_box - 0.05),
                         state.ee_box + 0.05)

    # warm-start carry: step taken -> carry; failed gate -> carry (the next
    # solve continues the same QP); passed gate but Armijo rejected every
    # candidate -> reset to the cold sentinel
    new_warm = None
    if state.qp_warm is not None:
        reset = good & (alpha == 0.0)
        new_warm = dataclasses.replace(
            sol, gap=torch.where(reset, torch.full_like(sol.gap, float("inf")),
                                 sol.gap))

    sel = torch.argmin(torch.abs(alphas[None, :] - alpha[:, None]), dim=-1)
    at0 = alpha == 0.0

    def pick(v, v0):
        return torch.where(at0, v0, torch.gather(v, 1, sel[:, None])[:, 0])

    stats = SolveStats(
        cost=pick(costs, cost0), merit=pick(merits, merit0),
        defect_l1=pick(defects, defect0),
        step_norm=torch.linalg.vector_norm(p_u, dim=-1) * alpha, alpha=alpha,
        qp_gap=sol.gap, qp_pri=sol.pri_res, qp_dua=sol.dua_res, solved=good)
    new_state = SolverState(traj=traj_new, ee_box=ee_box, qp_warm=new_warm)
    if return_ext:
        return new_state, stats, SolveExt(qp=qp, sol=sol, traj_lin=traj)
    return new_state, stats
