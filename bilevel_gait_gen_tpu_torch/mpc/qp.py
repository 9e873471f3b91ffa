"""Condensed QP assembly (port of the closed-form ``assemble`` of
``bilevel_gait_gen_tpu/mpc/qp.py``), batch first.

The dynamics equalities are condensed out by a loop over the nodes, so the
decision vector is the spline inputs u only; every constraint coefficient
is a dense masked product over the spline basis weights.  The JAX package
scatters per-end-effector blocks with ``.at[idx_e, ..., idx_e].set``; here
the same block-diagonal layout is a product with the identity over end
effectors, which is exact and differentiable.  Everything is differentiable
in ``traj.sched.bounds`` by autograd.  ``assemble_ad`` (the autodiff
reference build) and the Raibert rows (``cfg.raibert``) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from bilevel_gait_gen_tpu_torch.models import srb
from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc import gait as gait_mod
from bilevel_gait_gen_tpu_torch.mpc.trajectory import Trajectory, ravel_u
from bilevel_gait_gen_tpu_torch.ops import quat as quat_ops
from bilevel_gait_gen_tpu_torch.ops import spline
from bilevel_gait_gen_tpu.utils.config import MPCConfig


@dataclasses.dataclass(frozen=True)
class CondensedQP:
    H: torch.Tensor           # [B, n_u, n_u]
    q: torch.Tensor           # [B, n_u]
    A: torch.Tensor           # [B, p, n_u] equalities (masked rows zero)
    b: torch.Tensor           # [B, p]
    G: torch.Tensor           # [B, m, n_u] inequalities
    h: torch.Tensor           # [B, m]
    S: torch.Tensor           # [B, N+1, 12, n_u] state condensing maps
    c: torch.Tensor           # [B, N+1, 12] state offsets
    cost_const: torch.Tensor  # [B]


def friction_pyramid(mu: float, *, dtype: torch.dtype,
                     device=None) -> torch.Tensor:
    """4x3 pyramid rows F f <= 0: +-fx - mu fz, +-fy - mu fz."""
    return torch.tensor([[1.0, 0.0, -mu], [-1.0, 0.0, -mu],
                         [0.0, 1.0, -mu], [0.0, -1.0, -mu]],
                        dtype=dtype, device=device)


def _sample_times(bounds_ee: torch.Tensor, cfg: MPCConfig) -> torch.Tensor:
    """[..., S, FB] force-constraint sample times i/FB through each stance;
    bounds_ee [..., P+1]."""
    S, FB = cfg.num_stance_slots, cfg.samples_per_stance
    td = bounds_ee[..., 0:2 * S:2]
    lo = bounds_ee[..., 1:2 * S + 1:2]
    frac = torch.arange(FB, dtype=bounds_ee.dtype,
                        device=bounds_ee.device) / FB
    return td[..., :, None] + frac * (lo - td)[..., :, None]


def _block_diag_ee(x: torch.Tensor, e_dim: int, at: int) -> torch.Tensor:
    """Insert an end-effector axis of size E at position ``at`` (counted in
    the output) holding x on its diagonal with axis ``e_dim`` of x:
    out[..., e, ..., g, ...] = x[..., e, ...] * (e == g)."""
    E = x.shape[e_dim]
    eye = torch.eye(E, dtype=x.dtype, device=x.device)
    y = x.unsqueeze(at)
    shape = [1] * y.ndim
    shape[e_dim if e_dim < at else e_dim + 1] = E
    shape[at] = E
    return y * eye.reshape(shape)


def assemble(cfg: MPCConfig, params: SRBParams, traj: Trajectory,
             x0_man: torch.Tensor, t0: torch.Tensor, ee_pos0: torch.Tensor,
             x_des_tan: torch.Tensor,
             ee_box_size: torch.Tensor) -> CondensedQP:
    """Build the condensed QP around ``traj`` for a batch of scenarios.

    x0_man [B, 13], t0 [B], ee_pos0 [B, E, 3], x_des_tan [B, 12],
    ee_box_size [B, 2]."""
    if cfg.raibert:
        raise NotImplementedError("Raibert rows are not ported yet")
    N, dt, E = cfg.num_nodes, cfg.dt, cfg.num_ee
    F = cfg.num_force_polys
    S_slots = cfg.num_stance_slots
    K = F - 1
    NF = cfg.num_footholds
    n_u = cfg.num_u
    nf = cfg.num_force_vars
    dtype, dev = x0_man.dtype, x0_man.device
    B = x0_man.shape[0]
    bounds = traj.sched.bounds                                # [B, E, P+1]
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    xs_tan = srb.manifold_to_tangent(traj.x_man)              # [B, N+1, 12]
    times = t0[:, None] + dt * torch.arange(N + 1, dtype=dtype, device=dev)

    # ---- spline basis weights at the node times --------------------------
    def weights_at(ts_):
        bb = bounds[:, None]                                  # [B, 1, E, P+1]
        tt = ts_[:, :, None]                                  # [B, N+1, 1]
        wf = spline.force_weights(bb, tt, F)            # [B, N+1, E, S, K, 2]
        wp = spline.foothold_weights(bb, tt)            # [B, N+1, E, NF]
        zz = spline.foot_z_value(bb, tt, cfg.swing_height, cfg.foot_offset)
        return wf, wp, zz

    wf_n, wp_n, z_n = weights_at(times)
    if cfg.integrator == "rk2":
        lin_times = times + 0.5 * dt
        wf_lin, wp_lin, z_lin = weights_at(lin_times)
    else:
        lin_times = times
        wf_lin, wp_lin, z_lin = wf_n, wp_n, z_n

    f_traj = torch.einsum('bkesnw,besncw->bkec', wf_lin, traj.f_nodes)
    if cfg.force_carrier:
        carr_lin = spline.carrier_weights(bounds[:, None], lin_times,
                                          cfg.carrier_ramp)  # [B, N+1, E]
        f_traj = torch.cat([f_traj[..., :2], f_traj[..., 2:]
                            + (carr_lin * (params.mass * 9.81))[..., None]],
                           dim=-1)
    feet_xy_lin = torch.einsum('bkem,bemc->bkec', wp_lin, traj.footholds)
    feet = torch.cat([feet_xy_lin, z_lin[..., None]], dim=-1)

    # ---- closed-form continuous linearization, all nodes at once ---------
    Ir = params.inertia.to(dtype)
    Ir_inv = params.inertia_inv.to(dtype)
    m_inv = 1.0 / params.mass
    x = xs_tan[:, :N]                                         # [B, N, 12]
    p, h, w = x[..., 0:3], x[..., 3:6], x[..., 9:12]
    Fk = f_traj[:, :N]                                        # [B, N, E, 3]
    rk = feet[:, :N]
    F_tot = torch.sum(Fk, dim=-2)
    Irw = (Ir @ w[..., None])[..., 0]
    A = torch.zeros(B, N, 12, 12, dtype=dtype, device=dev)
    A[..., 0:3, 3:6] = m_inv * eye3
    A[..., 6:9, 9:12] = Ir_inv
    A[..., 9:12, 9:12] = quat_ops.skew(Irw) - quat_ops.skew(w) @ Ir
    A[..., 9:12, 0:3] = quat_ops.skew(F_tot)

    # force block: dhdot/df = I w;  dwdot/df = skew(r - p) w
    wf_k = wf_n[:, :N]                                  # [B, N, E, S, K, 2]
    skews_r = quat_ops.skew(rk - p[..., None, :])             # [B, N, E, 3, 3]
    Bf = torch.zeros(B, N, 12, E, S_slots, K, 3, 2, dtype=dtype, device=dev)
    Bf[:, :, 3:6] = torch.einsum('cd,bkesnw->bkcesndw', eye3, wf_k)
    Bf[:, :, 9:12] = torch.einsum('bkecd,bkesnw->bkcesndw', skews_r, wf_k)
    # foothold block: dwdot/dr_xy = -skew(f)[:, :2] w_p
    skews_f = quat_ops.skew(Fk)
    Bp = torch.zeros(B, N, 12, E, NF, 2, dtype=dtype, device=dev)
    Bp[:, :, 9:12] = torch.einsum('bkecd,bkem->bkcemd', -skews_f[..., :, 0:2],
                                  wp_n[:, :N])
    Bmat = torch.cat([Bf.reshape(B, N, 12, nf),
                      Bp.reshape(B, N, 12, n_u - nf)], dim=-1)

    wdot = (-torch.linalg.cross(w, Irw)
            + torch.sum(torch.linalg.cross(rk - p[..., None, :], Fk, dim=-1),
                        dim=-2))
    xdot = torch.cat([h * m_inv,
                      params.mass * srb.gravity(dtype, dev) + F_tot,
                      (Ir_inv @ w[..., None])[..., 0], wdot], dim=-1)
    u_lin = ravel_u(traj.f_nodes, traj.footholds)             # [B, n_u]
    C = (xdot - (A @ x[..., None])[..., 0]
         - (Bmat @ u_lin[:, None, :, None])[..., 0])
    I12 = torch.eye(12, dtype=dtype, device=dev)
    if cfg.integrator == "rk2":
        Ad = I12 + dt * A + 0.5 * dt * dt * (A @ A)
        M2 = dt * I12 + 0.5 * dt * dt * A
        Bd = M2 @ Bmat
        Cd = (M2 @ C[..., None])[..., 0]
    else:
        Ad, Bd, Cd = I12 + dt * A, dt * Bmat, dt * C

    S_k = torch.zeros(B, 12, n_u, dtype=dtype, device=dev)
    c_k = srb.manifold_to_tangent(x0_man)
    S_list, c_list = [S_k], [c_k]
    for k in range(N):
        S_k = Ad[:, k] @ S_k + Bd[:, k]
        c_k = (Ad[:, k] @ c_k[..., None])[..., 0] + Cd[:, k]
        S_list.append(S_k)
        c_list.append(c_k)
    S_stack = torch.stack(S_list, dim=1)                    # [B, N+1, 12, n_u]
    c_stack = torch.stack(c_list, dim=1)                    # [B, N+1, 12]

    # ---- cost ------------------------------------------------------------
    qdiag = torch.tensor(cfg.q_diag, dtype=dtype, device=dev)
    Qk = (qdiag + cfg.diag_reg).expand(N + 1, 12)
    wk = (-qdiag * x_des_tan)[:, None, :].expand(B, N + 1, 12)
    SQ = S_stack * Qk[:, :, None]
    Sf = S_stack.reshape(B, (N + 1) * 12, n_u)
    H = SQ.reshape(B, (N + 1) * 12, n_u).mT @ Sf
    q = torch.einsum('bkiu,bki->bu', S_stack, Qk * c_stack + wk)
    u_diag = torch.cat([
        torch.full((nf,), cfg.force_cost + cfg.diag_reg, dtype=dtype,
                   device=dev),
        torch.full((cfg.num_pos_vars,), cfg.diag_reg, dtype=dtype,
                   device=dev)])
    H = H + torch.diag(u_diag)
    cost_const = (0.5 * torch.sum(Qk * c_stack * c_stack, dim=(-1, -2))
                  + torch.sum(wk * c_stack, dim=(-1, -2)))

    # ---- inequality rows from sample-time weights ------------------------
    ts = _sample_times(bounds, cfg)                           # [B, E, S, FB]
    wf_s = spline.force_weights(bounds[:, :, None, None, :], ts, F)
    # wf_s: [B, E, S, FB, S, K, 2]
    pyr = friction_pyramid(cfg.friction_coef, dtype=dtype, device=dev)
    cone_full = torch.einsum('rc,besfnkw->besfrnkcw', pyr, wf_s)
    G_cone = _block_diag_ee(cone_full, 1, 5).reshape(B, -1, nf)
    zpad = torch.zeros(B, G_cone.shape[1], n_u - nf, dtype=dtype, device=dev)
    G_cone = torch.cat([G_cone, zpad], dim=-1)

    zsel = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    fz_c = torch.einsum('besfnkw,c->besfnkcw', wf_s, zsel)
    G_fz = _block_diag_ee(fz_c, 1, 4).reshape(B, -1, nf)
    G_fz = torch.cat([G_fz, torch.zeros(B, G_fz.shape[1], n_u - nf,
                                        dtype=dtype, device=dev)], dim=-1)

    # EE box rows: foot_xy - com_xy per node >= ee_node_start
    ks = list(range(cfg.ee_node_start, N + 1))
    Nk = len(ks)
    wp_k = wp_n[:, ks]                                        # [B, Nk, E, NF]
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    bw = torch.einsum('bkem,cd->bkecmd', wp_k, eye2)
    Gp_box = _block_diag_ee(bw, 2, 4).reshape(B, Nk * E * 2, E * NF * 2)
    G_box_u = torch.cat([torch.zeros(B, Nk * E * 2, nf, dtype=dtype,
                                     device=dev), Gp_box], dim=-1)
    ones_e = torch.ones(E, dtype=dtype, device=dev)
    Sxy = S_stack[:, ks, 0:2, :]                              # [B, Nk, 2, n_u]
    G_com = torch.einsum('bkcu,e->bkecu', Sxy, ones_e).reshape(B, -1, n_u)
    G_box = G_box_u - G_com
    box_off = -torch.einsum('bkc,e->bkec', c_stack[:, ks, 0:2],
                            ones_e).reshape(B, -1)

    hip = params.hip_offset.to(dtype)                         # [E, 2]
    half_box = (ee_box_size / 2)[:, None, :]                  # [B, 1, 2]
    ub_box = (hip + half_box).reshape(B, -1).repeat(1, Nk)
    lb_box = (hip - half_box).reshape(B, -1).repeat(1, Nk)

    G = torch.cat([G_cone, G_fz, -G_fz, G_box, -G_box], dim=1)
    n_cone, n_fz = G_cone.shape[1], G_fz.shape[1]
    if cfg.force_carrier:
        carr_s = spline.carrier_weights(bounds[:, None, None, None], ts,
                                        cfg.carrier_ramp)
        # carr_s: [B, E, S, FB, E] -> own end effector's weight
        carr_s = torch.diagonal(carr_s, dim1=1, dim2=4).movedim(-1, 1)
        carr_s = carr_s * (params.mass * 9.81)                # [B, E, S, FB]
        h_cone = cfg.friction_coef * carr_s[..., None].expand(
            *carr_s.shape, 4).reshape(B, -1)
        h_fz_up = cfg.force_bound - carr_s.reshape(B, -1)
        h_fz_dn = carr_s.reshape(B, -1)
    else:
        h_cone = torch.zeros(B, n_cone, dtype=dtype, device=dev)
        h_fz_up = torch.full((B, n_fz), cfg.force_bound, dtype=dtype,
                             device=dev)
        h_fz_dn = torch.zeros(B, n_fz, dtype=dtype, device=dev)
    h_vec = torch.cat([h_cone, h_fz_up, h_fz_dn, ub_box - box_off,
                       -(lb_box - box_off)], dim=1)

    # ---- equalities ------------------------------------------------------
    def foothold_rows(wp_e):
        """[B, E, NF] weights -> [B, 2E, n_u] rows on each EE's footholds."""
        blk = torch.einsum('bem,cd->becmd', wp_e, eye2)
        blk = _block_diag_ee(blk, 1, 3).reshape(B, 2 * E, -1)
        return torch.cat([torch.zeros(B, 2 * E, nf, dtype=dtype, device=dev),
                          blk], dim=-1)

    # EE start: foot_xy(t0) = measured
    wp_0 = spline.foothold_weights(bounds, t0[:, None])       # [B, E, NF]
    A_start = foothold_rows(wp_0)
    b_start = ee_pos0[..., :2].reshape(B, -1)

    # TD pin: foot_xy(td) = current value, active when > td_fraction through
    td_t = gait_mod.next_touchdown_time(bounds, t0[:, None])  # [B, E]
    swing = gait_mod.current_swing_time(bounds, t0[:, None])
    td_active = (td_t - t0[:, None]) < cfg.td_fraction * swing
    wp_td = spline.foothold_weights(bounds, td_t)             # [B, E, NF]
    A_td = foothold_rows(wp_td)
    b_td = torch.einsum('bem,bemc->bec', wp_td, traj.footholds).reshape(B, -1)
    td_mask = torch.repeat_interleave(td_active, 2, dim=-1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    A_td = torch.where(td_mask[..., None], A_td, zero)
    b_td = torch.where(td_mask, b_td, zero)

    return CondensedQP(H=H, q=q, A=torch.cat([A_start, A_td], dim=1),
                       b=torch.cat([b_start, b_td], dim=1), G=G, h=h_vec,
                       S=S_stack, c=c_stack, cost_const=cost_const)


def recover_states(qp: CondensedQP, u: torch.Tensor) -> torch.Tensor:
    """[B, N+1, 12] tangent states implied by the QP solution u [B, n_u]."""
    return torch.einsum('bkiu,bu->bki', qp.S, u) + qp.c


def cost_value(cfg: MPCConfig, xs_tan: torch.Tensor, u: torch.Tensor,
               x_des_tan: torch.Tensor) -> torch.Tensor:
    """Exact QP cost at (states [..., N+1, 12], inputs [..., n_u]) with
    x_des_tan [..., 12]."""
    dtype, dev = u.dtype, u.device
    qd = torch.tensor(cfg.q_diag, dtype=dtype, device=dev)
    qdiag = qd + cfg.diag_reg
    w = -qd * x_des_tan
    state_cost = (0.5 * torch.sum(qdiag * xs_tan * xs_tan, dim=(-1, -2))
                  + torch.sum(xs_tan * w[..., None, :], dim=(-1, -2)))
    u_diag = torch.cat([
        torch.full((cfg.num_force_vars,), cfg.force_cost + cfg.diag_reg,
                   dtype=dtype, device=dev),
        torch.full((cfg.num_pos_vars,), cfg.diag_reg, dtype=dtype,
                   device=dev)])
    return state_cost + 0.5 * torch.sum(u_diag * u * u, dim=-1)
