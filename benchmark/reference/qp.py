"""Condensed QP assembly (port of the closed-form ``assemble`` of
``bilevel_gait_gen_tpu/mpc/qp.py``), batch first.

The dynamics equalities are condensed out by a loop over the nodes, so the
decision vector is the spline inputs u only; every constraint coefficient
is a dense masked product over the spline basis weights.  The JAX package
scatters per-end-effector blocks with ``.at[idx_e, ..., idx_e].set``; here
the same block-diagonal layout is a product with the identity over end
effectors, which is exact and differentiable.  Everything is differentiable
in ``traj.sched.bounds`` by autograd.  :func:`assemble_ad` builds the same
QP by autodiff of the spline and dynamics functions, one scenario at a time:
the oracle the tests hold :func:`assemble` to.
"""
from __future__ import annotations

import dataclasses

import torch

from . import srb
from .srb import SRBParams
from . import gait as gait_mod
from .trajectory import Trajectory, ravel_u
from . import quat as quat_ops
from . import spline
from . import jnp_compat as jc
from .config import MPCConfig
from .consts import const


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
    """4x3 pyramid rows F f <= 0: +-fx - mu fz, +-fy - mu fz; ``device``
    None means the GPU."""
    return const(((1.0, 0.0, -mu), (-1.0, 0.0, -mu),
                  (0.0, 1.0, -mu), (0.0, -1.0, -mu)), dtype, device)


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
             x_des_tan: torch.Tensor, ee_box_size: torch.Tensor,
             node_inertia: torch.Tensor | None = None) -> CondensedQP:
    """Build the condensed QP around ``traj`` for a batch of scenarios.

    x0_man [B, 13], t0 [B], ee_pos0 [B, E, 3], x_des_tan [B, 12],
    ee_box_size [B, 2].  ``node_inertia`` [B, N(+1), 3, 3], where given,
    is the per-node composite rotational inertia of the centroidal variant
    (the first N nodes enter the dynamics linearization); None is the SRB's
    constant nominal inertia.  Its inverse is ``inv_ex``'s, which reads no
    status back to the host."""
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
    if node_inertia is None:
        Ir = params.inertia.to(dtype)
        Ir_inv = params.inertia_inv.to(dtype)
    else:
        Ir = node_inertia[:, :N].to(dtype)                    # [B, N, 3, 3]
        Ir_inv = torch.linalg.inv_ex(Ir).inverse
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
    qdiag = const(cfg.q_diag, dtype, dev)
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

    zsel = const((0.0, 0.0, 1.0), dtype, dev)
    fz_c = torch.einsum('besfnkw,c->besfnkcw', wf_s, zsel)
    G_fz = _block_diag_ee(fz_c, 1, 4).reshape(B, -1, nf)
    G_fz = torch.cat([G_fz, torch.zeros(B, G_fz.shape[1], n_u - nf,
                                        dtype=dtype, device=dev)], dim=-1)

    # EE box rows: foot_xy - com_xy per node >= ee_node_start
    ks = slice(cfg.ee_node_start, N + 1)
    Nk = N + 1 - cfg.ee_node_start
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

    A_parts, b_parts = [A_start, A_td], [b_start, b_td]
    if cfg.raibert:
        # Raibert rows: foot_xy(td) - com_xy(node) - kappa h_xy(node) =
        # hip offset - kappa h_des, for every touchdown inside the horizon;
        # kappa = vel_gain T_stance / (2 m)
        td_all = bounds[..., 0::2]                            # [B, E, NT]
        NT = td_all.shape[-1]
        t0e = t0[:, None, None]
        nodes = torch.clamp(torch.floor(
            (td_all - t0e) / dt - 1e-2 / dt).long(), 0, N)
        t_st = bounds[..., 1::2] - bounds[..., 0:-1:2]
        t_stance = torch.cat([t_st, torch.ones_like(t_st[..., :1])],
                             dim=-1)[..., :NT]
        vg = const(cfg.raibert_vel_gain, dtype, dev).expand(2)
        kappa = vg * t_stance[..., None] / (2.0 * params.mass)  # [B,E,NT,2]
        wp_r = spline.foothold_weights(bounds[:, :, None, :], td_all)
        rw = torch.einsum('bejm,cd->bejcmd', wp_r, eye2)
        A_r_p = _block_diag_ee(rw, 1, 4).reshape(B, E * NT * 2, E * NF * 2)
        A_r_u = torch.cat([torch.zeros(B, E * NT * 2, nf, dtype=dtype,
                                       device=dev), A_r_p], dim=-1)
        b_ix = torch.arange(B, device=dev)[:, None, None]
        S_nodes = S_stack[b_ix, nodes]                  # [B, E, NT, 12, n_u]
        c_nodes = c_stack[b_ix, nodes]                        # [B, E, NT, 12]
        A_raib = A_r_u - (S_nodes[..., 0:2, :] + kappa[..., None]
                          * S_nodes[..., 3:5, :]).reshape(B, E * NT * 2, n_u)
        hip_r = params.hip_offset_raw.to(dtype) * const(
            cfg.raibert_hip_scale, dtype, dev)
        h_des = x_des_tan[:, None, None, 3:5]
        b_raib = (hip_r[None, :, None, :] - kappa * h_des
                  + c_nodes[..., 0:2] + kappa * c_nodes[..., 3:5]
                  ).reshape(B, -1)
        mask_r = torch.repeat_interleave(
            _raibert_active(cfg, bounds, t0, td_active, td_t).reshape(B, -1),
            2, dim=-1)
        A_parts.append(torch.where(mask_r[..., None], A_raib, zero))
        b_parts.append(torch.where(mask_r, b_raib, zero))

    return CondensedQP(H=H, q=q, A=torch.cat(A_parts, dim=1),
                       b=torch.cat(b_parts, dim=1), G=G, h=h_vec,
                       S=S_stack, c=c_stack, cost_const=cost_const)


def _raibert_active(cfg: MPCConfig, bounds, t0, td_active, td_t):
    """[..., E, NT] touchdowns that get a Raibert row: inside the horizon,
    after a real swing (a chained standing stance is no landing), and not
    already claimed by the TD pin.  bounds [..., E, P+1], t0 [...],
    td_active and td_t [..., E]."""
    td_all = bounds[..., 0::2]
    NT = td_all.shape[-1]
    t0e = t0[..., None, None]
    prv_sw = td_all - torch.cat([td_all[..., :1] - 1.0,
                                 bounds[..., 1::2][..., :NT - 1]], dim=-1)
    return ((td_all > t0e) & (td_all < t0e + cfg.num_nodes * cfg.dt)
            & (prv_sw > 1e-4)
            & ~(td_active[..., None]
                & (torch.abs(td_all - td_t[..., None]) < 1e-9)))


def assemble_ad(cfg: MPCConfig, params: SRBParams, traj: Trajectory,
                x0_man: torch.Tensor, t0: torch.Tensor, ee_pos0: torch.Tensor,
                x_des_tan: torch.Tensor,
                ee_box_size: torch.Tensor) -> CondensedQP:
    """The condensed QP of :func:`assemble` built by autodiff: the dynamics
    linearized with ``srb.linearize``, the constraint rows as Jacobians of
    the spline value functions.  Euler discretization only.  One scenario
    at a time in a Python loop: an oracle for tests, not a serving path."""
    B = x0_man.shape[0]
    qps = [_assemble_ad_one(cfg, params, traj.x_man[i], traj.f_nodes[i],
                            traj.footholds[i], traj.sched.bounds[i],
                            x0_man[i], t0[i], ee_pos0[i], x_des_tan[i],
                            ee_box_size[i]) for i in range(B)]
    return CondensedQP(**{f.name: torch.stack([getattr(q, f.name)
                                               for q in qps])
                          for f in dataclasses.fields(CondensedQP)})


def _assemble_ad_one(cfg, params, x_man, f_nodes, footholds, bounds, x0_man,
                     t0, ee_pos0, x_des_tan, ee_box_size) -> CondensedQP:
    from .trajectory import make_unravel
    N, dt, E = cfg.num_nodes, cfg.dt, cfg.num_ee
    dtype, dev = x0_man.dtype, x0_man.device
    unravel = make_unravel(cfg)
    u_prev = ravel_u(f_nodes, footholds)
    n_u = u_prev.shape[0]
    xs_tan = srb.manifold_to_tangent(x_man)
    times = t0 + dt * torch.arange(N + 1, dtype=dtype, device=dev)

    # ---- dynamics linearization and condensing ----------------------------
    def rep(a):
        return a.expand(N, *a.shape)

    A, Bm, C = srb.linearize(params, xs_tan[:N], rep(f_nodes),
                             rep(footholds), unravel, rep(u_prev),
                             rep(bounds), times[:N], cfg)
    I12 = torch.eye(12, dtype=dtype, device=dev)
    S_k = torch.zeros(12, n_u, dtype=dtype, device=dev)
    c_k = srb.manifold_to_tangent(x0_man)
    S_list, c_list = [S_k], [c_k]
    for k in range(N):
        S_k = (I12 + dt * A[k]) @ S_k + dt * Bm[k]
        c_k = (I12 + dt * A[k]) @ c_k + dt * C[k]
        S_list.append(S_k)
        c_list.append(c_k)
    S_stack, c_stack = torch.stack(S_list), torch.stack(c_list)

    # ---- cost -------------------------------------------------------------
    qdiag = const(cfg.q_diag, dtype, dev)
    Qk = (qdiag + cfg.diag_reg).expand(N + 1, 12)
    wk = (-qdiag * x_des_tan).expand(N + 1, 12)
    Sf = S_stack.reshape((N + 1) * 12, n_u)
    H = (S_stack * Qk[:, :, None]).reshape((N + 1) * 12, n_u).T @ Sf
    q = torch.einsum('kiu,ki->u', S_stack, Qk * c_stack + wk)
    u_diag = torch.cat([
        torch.full((cfg.num_force_vars,), cfg.force_cost + cfg.diag_reg,
                   dtype=dtype, device=dev),
        torch.full((cfg.num_pos_vars,), cfg.diag_reg, dtype=dtype,
                   device=dev)])
    H = H + torch.diag(u_diag)
    cost_const = (0.5 * torch.sum(Qk * c_stack * c_stack)
                  + torch.sum(wk * c_stack))

    # ---- inequality rows ---------------------------------------------------
    pyr = friction_pyramid(cfg.friction_coef, dtype=dtype, device=dev)
    FB, S_slots = cfg.samples_per_stance, cfg.num_stance_slots
    ts = _sample_times(bounds, cfg)                           # [E, S, FB]
    ks = slice(cfg.ee_node_start, N + 1)

    def ineq_vals(u):
        fn, fh = unravel(u)
        f = spline.force_value(bounds[:, None, None, :],
                               fn[:, None, None], ts,
                               cfg.num_force_polys)           # [E, S, FB, 3]
        if cfg.force_carrier:
            carr = spline.carrier_weights(bounds, ts, cfg.carrier_ramp)
            own = torch.diagonal(carr, dim1=0, dim2=3).movedim(-1, 0)
            f = torch.cat([f[..., :2], f[..., 2:]
                           + (own * (params.mass * 9.81))[..., None]], dim=-1)
        cone = torch.einsum('ri,esfi->esfr', pyr, f).reshape(-1)
        fz = f[..., 2].reshape(-1)
        com_xy = S_stack[ks, 0:2] @ u + c_stack[ks, 0:2]       # [Nk, 2]
        feet = spline.foot_positions_all(bounds, fh, times[ks],
                                         cfg.swing_height, cfg.foot_offset)
        box = (feet[..., :2] - com_xy[:, None, :]).reshape(-1)
        return torch.cat([cone, fz, box])

    v0 = ineq_vals(torch.zeros_like(u_prev))
    G_half = torch.func.jacrev(ineq_vals)(u_prev)
    n_cone, n_fz = E * S_slots * FB * 4, E * S_slots * FB
    hip = params.hip_offset.to(dtype)
    half_box = (ee_box_size / 2).expand(E, 2)
    ub = (hip + half_box).reshape(-1).repeat(N + 1 - cfg.ee_node_start)
    lb = (hip - half_box).reshape(-1).repeat(N + 1 - cfg.ee_node_start)
    v_fz = v0[n_cone:n_cone + n_fz]
    G = torch.cat([G_half[:n_cone], G_half[n_cone:n_cone + n_fz],
                   -G_half[n_cone:n_cone + n_fz], G_half[n_cone + n_fz:],
                   -G_half[n_cone + n_fz:]])
    h = torch.cat([-v0[:n_cone], cfg.force_bound - v_fz, v_fz,
                   ub - v0[n_cone + n_fz:], -lb + v0[n_cone + n_fz:]])

    # ---- equality rows -----------------------------------------------------
    td_t = gait_mod.next_touchdown_time(bounds, t0)           # [E]
    swing = gait_mod.current_swing_time(bounds, t0)
    td_active = (td_t - t0) < cfg.td_fraction * swing
    td_all = bounds[:, 0::2]                                  # [E, NT]
    NT = td_all.shape[1]
    if cfg.raibert:
        nodes = torch.clamp(torch.floor(
            (td_all - t0) / dt - 1e-2 / dt).long(), 0, N)
        t_st = bounds[:, 1::2] - bounds[:, 0:-1:2]
        t_stance = torch.cat([t_st, torch.ones_like(t_st[:, :1])],
                             dim=-1)[:, :NT]
        vg = const(cfg.raibert_vel_gain, dtype, dev).expand(2)
        kappa = vg * t_stance[..., None] / (2.0 * params.mass)  # [E, NT, 2]

    def foot_xy(fh, tt):
        return spline.foot_position(bounds, fh, tt, cfg.swing_height,
                                    cfg.foot_offset)[..., :2]

    def eq_vals(u):
        _, fh = unravel(u)
        parts = [foot_xy(fh, t0).reshape(-1), foot_xy(fh, td_t).reshape(-1)]
        if cfg.raibert:
            foot = spline.foot_position(bounds[:, None, :], fh[:, None],
                                        td_all, cfg.swing_height,
                                        cfg.foot_offset)[..., :2]
            x_node = S_stack[nodes] @ u + c_stack[nodes]       # [E, NT, 12]
            parts.append((foot - x_node[..., 0:2]
                          - kappa * x_node[..., 3:5]).reshape(-1))
        return torch.cat(parts)

    ev0 = eq_vals(torch.zeros_like(u_prev))
    A_eq = torch.func.jacrev(eq_vals)(u_prev)
    td_now = foot_xy(footholds, td_t).reshape(-1)
    b_parts = [ee_pos0[:, :2].reshape(-1) - ev0[:2 * E],
               td_now - ev0[2 * E:4 * E]]
    mask_parts = [torch.ones(2 * E, dtype=torch.bool, device=dev),
                  torch.repeat_interleave(td_active, 2)]
    if cfg.raibert:
        hip_r = params.hip_offset_raw.to(dtype) * const(
            cfg.raibert_hip_scale, dtype, dev)
        hip_b = (hip_r[:, None, :] - kappa * x_des_tan[3:5]).reshape(-1)
        b_parts.append(hip_b - ev0[4 * E:])
        mask_parts.append(torch.repeat_interleave(
            _raibert_active(cfg, bounds, t0, td_active, td_t).reshape(-1), 2))
    mask = torch.cat(mask_parts)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return CondensedQP(H=H, q=q, A=torch.where(mask[:, None], A_eq, zero),
                       b=torch.where(mask, torch.cat(b_parts), zero), G=G,
                       h=h, S=S_stack, c=c_stack, cost_const=cost_const)


def recover_states(qp: CondensedQP, u: torch.Tensor) -> torch.Tensor:
    """[B, N+1, 12] tangent states implied by the QP solution u [B, n_u]."""
    S = qp.S.flatten(-3, -2)                                  # [B, K 12, n_u]
    return jc.matvec(S, u).unflatten(-1, qp.S.shape[-3:-1]) + qp.c


def cost_value(cfg: MPCConfig, xs_tan: torch.Tensor, u: torch.Tensor,
               x_des_tan: torch.Tensor) -> torch.Tensor:
    """Exact QP cost at (states [..., N+1, 12], inputs [..., n_u]) with
    x_des_tan [..., 12]."""
    dtype, dev = u.dtype, u.device
    qd = const(cfg.q_diag, dtype, dev)
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
