"""Centroidal-dynamics MPC variant, batch first (port of
``bilevel_gait_gen_tpu/mpc/centroidal.py``; the design notes are there).

The same condensed-QP machinery as the SRB path, with the composite inertia
of each node's whole-body configuration in the dynamics linearization and
the joint velocities as decision variables, tied to the foot splines by
linearized forward-kinematics equality rows and box-bounded.  Decision
vector: u_c = [spline variables | v_j for nodes 0..N-1].

At the default ``MPCConfig`` (A1, N = 20) the QP has n = 472 variables,
p = 256 equality rows and m = 1712 inequality rows; on the card in float32
:func:`solve_centroidal_step` runs the fused sweep padded to n = 512,
m = 1792, p = 256, where ``kernels.ipm_iter`` runs its Schur stage before
the iteration kernel.  The JAX package's node ``vmap`` and ``lax.scan`` are
a batch of nodes and a Python loop here.  Like the reference,
:func:`make_centroidal_state` never seeds ``qp_warm``, so the warm start is
inert (every step solves cold); the port reproduces that.
"""
from __future__ import annotations

import dataclasses

import torch

from bilevel_gait_gen_tpu_torch.control import ik as ik_mod
from bilevel_gait_gen_tpu_torch.models import rbd, srb
from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel
from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc import gait as gait_mod
from bilevel_gait_gen_tpu_torch.mpc import qp as qp_mod
from bilevel_gait_gen_tpu_torch.mpc import solver as solver_mod
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (Trajectory,
                                                       make_unravel, ravel_u)
from bilevel_gait_gen_tpu_torch.ops import pdip, spline
from bilevel_gait_gen_tpu_torch.ops import quat as quat_ops
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch.utils.consts import const, filled
from bilevel_gait_gen_tpu_torch.utils.precision import set_fp32_precision


@dataclasses.dataclass(frozen=True)
class CentroidalQP:
    base: qp_mod.CondensedQP   # spline-variable part (with per-node Ir)
    H: torch.Tensor            # [B, n, n] incl. the joint-velocity block
    q: torch.Tensor            # [B, n]
    A: torch.Tensor            # [B, p, n]
    b: torch.Tensor            # [B, p]
    G: torch.Tensor            # [B, m, n]
    h: torch.Tensor            # [B, m]
    n_spline: int


def node_inertias(model: RobotModel, configs: torch.Tensor) -> torch.Tensor:
    """[..., N+1, 3, 3] composite inertia about the COM per node
    configuration [..., N+1, nq]."""
    return rbd.composite_inertia_about_com(model, configs)


def _block_diag(x: torch.Tensor) -> torch.Tensor:
    """[B, N, r, c] blocks -> [B, N r, N c] block-diagonal matrix."""
    B, N, r, c = x.shape
    eye = torch.eye(N, dtype=x.dtype, device=x.device)
    return torch.einsum('bkrc,kl->bkrlc', x, eye).reshape(B, N * r, N * c)


def assemble_centroidal(cfg: MPCConfig, model: RobotModel,
                        params: SRBParams, traj: Trajectory,
                        configs: torch.Tensor, x0_man: torch.Tensor,
                        t0: torch.Tensor, ee_pos0: torch.Tensor,
                        x_des_tan: torch.Tensor, ee_box_size: torch.Tensor,
                        vel_weight: float = 0.1) -> CentroidalQP:
    """Build the centroidal QP for B scenarios.

    configs [B, N+1, nq] (the node configurations by IK), x0_man [B, 13],
    t0 [B], ee_pos0 [B, E, 3], x_des_tan [B, 12], ee_box_size [B, 2].  The
    spline block is ``qp.assemble`` with the per-node composite inertia; the
    joint-velocity block appends the FK equality rows (linearized at the
    node configurations; the spline foot velocity by a forward difference,
    the base twist from the tangent state with the mean inertia) and the
    velocity bounds."""
    N, dt, E = cfg.num_nodes, cfg.dt, cfg.num_ee
    nj = model.num_joints
    nv_blk = N * nj
    dtype, dev = x0_man.dtype, x0_man.device
    B = x0_man.shape[0]

    Irs = node_inertias(model, configs)                       # [B, N+1, 3, 3]
    Ir_mean_inv = torch.linalg.inv_ex(torch.mean(Irs, dim=1)).inverse
    base = qp_mod.assemble(cfg, params, traj, x0_man, t0, ee_pos0, x_des_tan,
                           ee_box_size, node_inertia=Irs)
    n_s = base.H.shape[-1]

    # ---- cost: a small quadratic on the joint velocities -----------------
    z_sv = torch.zeros(B, n_s, nv_blk, dtype=dtype, device=dev)
    eye_v = torch.eye(nv_blk, dtype=dtype, device=dev)
    H = torch.cat([torch.cat([base.H, z_sv], dim=-1),
                   torch.cat([z_sv.mT, ((vel_weight + cfg.diag_reg) * eye_v)
                              .expand(B, nv_blk, nv_blk)], dim=-1)], dim=-2)
    q = torch.cat([base.q, torch.zeros(B, nv_blk, dtype=dtype, device=dev)],
                  dim=-1)

    # ---- FK velocity rows: J_j(q_k) v_j[k] = ee_vel(t_k) - J_base v_base --
    times = t0[:, None] + dt * torch.arange(N, dtype=dtype, device=dev)
    J = rbd.ee_jacobians(model, configs[:, :N]).to(dtype)  # [B, N, E, 3, nv]
    bb = traj.sched.bounds[:, None]
    fh = traj.footholds[:, None]
    f0 = spline.foot_positions_all(bb, fh, times, cfg.swing_height,
                                   cfg.foot_offset)
    f1 = spline.foot_positions_all(bb, fh, times + 1e-4, cfg.swing_height,
                                   cfg.foot_offset)
    ee_vel = (f1 - f0) / 1e-4                                 # [B, N, E, 3]
    x_k = srb.manifold_to_tangent(traj.x_man[:, :N])          # [B, N, 12]
    v_base = x_k[..., 3:6] / params.mass
    omega = (Ir_mean_inv[:, None] @ x_k[..., 9:12, None])[..., 0]
    tw = torch.cat([v_base, omega], dim=-1)                   # [B, N, 6]
    rhs = (ee_vel - torch.einsum('bneiv,bnv->bnei', J[..., :6], tw)
           ).reshape(B, N * 3 * E)
    A_fk = _block_diag(J[..., 6:].reshape(B, N, 3 * E, nj))

    p0 = base.A.shape[-2]
    A = torch.cat([
        torch.cat([base.A, torch.zeros(B, p0, nv_blk, dtype=dtype,
                                       device=dev)], dim=-1),
        torch.cat([torch.zeros(B, N * 3 * E, n_s, dtype=dtype, device=dev),
                   A_fk], dim=-1)], dim=-2)
    b = torch.cat([base.b, rhs.to(dtype)], dim=-1)

    # ---- inequalities: base rows + velocity bounds ----------------------
    m0 = base.G.shape[-2]
    vb = model.velocity_limit.to(dtype).repeat(N).expand(B, nv_blk)
    z_vs = torch.zeros(B, nv_blk, n_s, dtype=dtype, device=dev)
    eye_b = eye_v.expand(B, nv_blk, nv_blk)
    G = torch.cat([
        torch.cat([base.G, torch.zeros(B, m0, nv_blk, dtype=dtype,
                                       device=dev)], dim=-1),
        torch.cat([z_vs, eye_b], dim=-1),
        torch.cat([z_vs, -eye_b], dim=-1)], dim=-2)
    h = torch.cat([base.h, vb, vb], dim=-1)
    return CentroidalQP(base=base, H=H, q=q, A=A, b=b, G=G, h=h,
                        n_spline=n_s)


def solve_centroidal(cqp: CentroidalQP, *, iters: int = 25,
                     tol: float = 1e-9):
    """Solve the centroidal QP; returns (spline variables u [B, n_s], joint
    velocities [B, N nj], solution)."""
    sol = pdip.solve(cqp.H, cqp.q, cqp.A, cqp.b, cqp.G, cqp.h, iters=iters,
                     tol=tol)
    return sol.x[:, :cqp.n_spline], sol.x[:, cqp.n_spline:], sol


# ----------------------------------------------------------------------------
# The real-time iteration of the centroidal variant
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CentroidalState:
    """Warm-start carry of the centroidal RTI for B scenarios."""
    traj: Trajectory
    ee_box: torch.Tensor                      # [B, 2]
    configs: torch.Tensor                     # [B, N+1, nq] node configs
    qp_warm: pdip.QPSolution | None = None
    vj: torch.Tensor | None = None            # [B, N, nj] last joint vels


def make_centroidal_state(cfg: MPCConfig, model: RobotModel,
                          traj: Trajectory, ee_box: torch.Tensor,
                          q0: torch.Tensor) -> CentroidalState:
    """Fresh centroidal carry (ee_box [B, 2], q0 [B, nq]): node configs
    seeded with q0, zero joint velocities.  ``qp_warm`` stays None, as in
    the reference: the warm start is inert."""
    N = cfg.num_nodes
    B = q0.shape[0]
    return CentroidalState(
        traj=traj, ee_box=ee_box,
        configs=q0[:, None, :].expand(B, N + 1, q0.shape[-1]).clone(),
        vj=torch.zeros(B, N, model.num_joints, dtype=ee_box.dtype,
                       device=ee_box.device))


def ik_node_configs(model: RobotModel, cfg: MPCConfig, params: SRBParams,
                    traj: Trajectory, t0: torch.Tensor,
                    q_guess: torch.Tensor) -> torch.Tensor:
    """[B, N+1, nq] whole-body configurations along the trajectory by DLS
    IK over the flattened node batch (t0 [B], q_guess [B, nq])."""
    N = cfg.num_nodes
    B = q_guess.shape[0]
    times = t0[:, None] + cfg.dt * torch.arange(N + 1, dtype=q_guess.dtype,
                                                device=q_guess.device)
    feet = spline.foot_positions_all(traj.sched.bounds[:, None],
                                     traj.footholds[:, None], times,
                                     cfg.swing_height, cfg.foot_offset)
    quat = quat_ops.normalize(traj.x_man[..., 6:10])
    base_pos = traj.x_man[..., 0:3] - (quat_ops.to_matrix(quat)
                                       @ params.com_offset[:, None])[..., 0]
    return ik_mod.solve_ik(model, base_pos, quat, feet,
                           q_guess[:, None].expand(B, N + 1, -1))


def _defect_l1_centroidal(cfg: MPCConfig, params: SRBParams,
                          Irs: torch.Tensor, xs_tan: torch.Tensor, f_nodes,
                          footholds, bounds, t0) -> torch.Tensor:
    """L1 nonlinear integration defect with the per-node composite inertia:
    ``solver._defect_l1`` with Irs [..., N+1, 3, 3] (broadcast against
    xs_tan's leading dimensions) in place of the constant inertia."""
    Ir = Irs[..., :cfg.num_nodes, :, :]
    params_k = dataclasses.replace(params, inertia=Ir,
                                   inertia_inv=torch.linalg.inv_ex(Ir).inverse)
    return solver_mod._defect_l1(cfg, params_k, xs_tan, f_nodes, footholds,
                                 bounds, t0)


def solve_centroidal_step(cfg: MPCConfig, model: RobotModel,
                          params: SRBParams, state: CentroidalState,
                          x0_man: torch.Tensor, t0: torch.Tensor,
                          ee_pos0: torch.Tensor, x_des_tan: torch.Tensor,
                          shift_window: bool = True):
    """One centroidal real-time iteration for B scenarios: window shift,
    node IK, per-node-inertia relinearization, the QP (splines and joint
    velocities under FK rows), the L1-merit Armijo line search, the convex
    update and the quality gate.  x0_man [B, 13], t0 [B], ee_pos0
    [B, E, 3], x_des_tan [B, 12].  Returns (CentroidalState,
    solver.SolveStats).  Reads nothing back to the host, so a CUDA graph
    can replay it."""
    set_fp32_precision()
    traj = state.traj
    unravel = make_unravel(cfg)
    dtype, dev = x0_man.dtype, x0_man.device
    B = x0_man.shape[0]
    N, nj = cfg.num_nodes, model.num_joints

    if shift_window:
        n_past = gait_mod.past_cycles(traj.sched, t0)
        sched = gait_mod.advance_window(traj.sched, t0, cfg)
        f_nodes, footholds = gait_mod.roll_spline_vars(
            traj.f_nodes, traj.footholds, n_past)
        traj = Trajectory(x_man=traj.x_man, f_nodes=f_nodes,
                          footholds=footholds, sched=sched)

    # node configurations by IK from the (shifted) plan: the linearization
    # point of the composite inertia and of the FK rows
    configs = ik_node_configs(model, cfg, params, traj, t0,
                              state.configs[:, 0])
    Irs = node_inertias(model, configs)
    cqp = assemble_centroidal(cfg, model, params, traj, configs, x0_man, t0,
                              ee_pos0, x_des_tan, state.ee_box)
    sol = pdip.solve(cqp.H, cqp.q, cqp.A, cqp.b, cqp.G, cqp.h,
                     iters=cfg.ipm_iters, tol=cfg.ipm_tol,
                     warm=state.qp_warm)

    n_s = cqp.n_spline
    u_prev = ravel_u(traj.f_nodes, traj.footholds)
    xs_prev = srb.manifold_to_tangent(traj.x_man)
    u_star = sol.x[:, :n_s]
    vj_star = sol.x[:, n_s:].reshape(B, N, nj)
    xs_star = qp_mod.recover_states(cqp.base, u_star)
    p_u = u_star - u_prev
    p_x = xs_star - xs_prev

    # merit line search on the per-node-inertia defect: alpha = 0 and the
    # halving grid at once
    mu = cfg.merit_mu
    alphas = 0.5 ** torch.arange(cfg.max_ls_iters + 1, dtype=dtype,
                                 device=dev)
    a_all = torch.cat([torch.zeros(1, dtype=dtype, device=dev), alphas])
    u_a = u_prev[:, None, :] + a_all[None, :, None] * p_u[:, None, :]
    xs_a = xs_prev[:, None] + a_all[None, :, None, None] * p_x[:, None]
    fn_a, fh_a = unravel(u_a)
    defects_all = _defect_l1_centroidal(cfg, params, Irs[:, None], xs_a,
                                        fn_a, fh_a,
                                        traj.sched.bounds[:, None],
                                        t0[:, None])
    costs_all = qp_mod.cost_value(cfg, xs_a, u_a, x_des_tan[:, None, :])
    merits_all = mu * defects_all + costs_all
    merit0, defect0, cost0 = (merits_all[:, 0], defects_all[:, 0],
                              costs_all[:, 0])
    merits, defects, costs = (merits_all[:, 1:], defects_all[:, 1:],
                              costs_all[:, 1:])

    scale = 1.0 + torch.maximum(torch.amax(torch.abs(cqp.q), dim=-1),
                                torch.abs(cost0))
    good = ((sol.gap < 1e-3 * scale) & (sol.pri_res < 1e-3 * scale)
            & torch.isfinite(sol.x).all(-1))

    grad_cost = pdip._mv(cqp.H[:, :n_s, :n_s], u_prev) + cqp.q[:, :n_s]
    dir_deriv = torch.sum(grad_cost * p_u, dim=-1) - mu * defect0
    armijo_ok = ((merit0[:, None] - merits)
                 >= -1e-5 * alphas * dir_deriv[:, None])
    first_ok = torch.argmax(armijo_ok.to(torch.int32), dim=-1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    alpha = torch.where(armijo_ok.any(-1), alphas[first_ok], zero)
    alpha = torch.where(good, alpha, zero)

    u_new = torch.where(good[:, None], u_prev + alpha[:, None] * p_u, u_prev)
    xs_new = torch.where(good[:, None, None],
                         xs_prev + alpha[:, None, None] * p_x, xs_prev)
    fn_new, fh_new = unravel(u_new)
    traj_new = Trajectory(x_man=srb.tangent_to_manifold(xs_new),
                          f_nodes=fn_new, footholds=fh_new, sched=traj.sched)

    nominal = const(cfg.ee_box_size, dtype, dev)
    ee_box = torch.where(good[:, None],
                         torch.maximum(nominal, state.ee_box - 0.05),
                         state.ee_box + 0.05)

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

    stats = solver_mod.SolveStats(
        cost=pick(costs, cost0), merit=pick(merits, merit0),
        defect_l1=pick(defects, defect0),
        step_norm=torch.linalg.vector_norm(p_u, dim=-1) * alpha, alpha=alpha,
        qp_gap=sol.gap, qp_pri=sol.pri_res, qp_dua=sol.dua_res, solved=good)
    # the carry keeps the input's structure: vj stays None if the caller
    # did not allocate it (make_centroidal_state does)
    vj_out = None
    if state.vj is not None:
        vj_out = torch.where(good[:, None, None], vj_star, state.vj)
    new_state = CentroidalState(traj=traj_new, ee_box=ee_box, configs=configs,
                                qp_warm=new_warm, vj=vj_out)
    return new_state, stats


def create_initial_run_centroidal(cfg: MPCConfig, model: RobotModel,
                                  params: SRBParams, state: CentroidalState,
                                  x0_man: torch.Tensor,
                                  ee_pos0: torch.Tensor,
                                  x_des_tan: torch.Tensor,
                                  t0: torch.Tensor | float = 0.0):
    """SQP to convergence before the centroidal RTI goes real time:
    ``cfg.init_run_iters`` steps without window shift.  ``t0`` is a scalar
    or [B].  Returns the final state and the last step's stats."""
    t0 = filled(t0, x0_man.shape[:1], x0_man.dtype, x0_man.device)
    stats = None
    for _ in range(cfg.init_run_iters):
        state, stats = solve_centroidal_step(cfg, model, params, state,
                                             x0_man, t0, ee_pos0, x_des_tan,
                                             shift_window=False)
    return state, stats
