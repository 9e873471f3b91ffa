"""Whole-body QP torque controller, batch first (port of
``bilevel_gait_gen_tpu/control/wbqp.py``; the reference's design is
documented there).

One QP per scenario over [qdd (nv), lambda (3 per foot)]: floating-base
dynamics and stationary-contact equalities, torque limits and friction
pyramids, PD tracking costs.  Contact on/off masks rows (fixed shapes), and
the B problems go through one batched ``pdip.solve``; at n = nv + 3E = 30
it takes the unrolled path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from . import rbd
from .rbd import RobotModel
from . import pdip
from . import quat as quat_ops
from .consts import const


@dataclasses.dataclass(frozen=True)
class WBQPConfig:
    """Gains and weights (the port's own copy of the JAX package's
    ``WBQPConfig``; the values' sources are documented there)."""
    kd_base_pos: float = 3000.0
    kp_base_pos: float = 9000.0
    kd_base_ang: float = 100.0
    kp_base_ang: float = 1000.0
    kp_joint: float = 1200.0
    kd_joint: float = 300.0
    leg_weight: float = 10.0
    torso_weight: float = 1000.0
    force_weight: float = 10.0
    friction_coef: float = 0.5
    torque_bound: float = 30.0
    contact_damp: float = 0.0
    ipm_iters: int = 15


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """[..., E, r, c] -> the block-diagonal [..., E r, E c]."""
    E, r, c = blocks.shape[-3:]
    eye = torch.eye(E, dtype=blocks.dtype, device=blocks.device)
    full = blocks[..., :, :, None, :] * eye[:, None, :, None]
    return full.reshape(*blocks.shape[:-3], E * r, E * c)


def compute_torques(model: RobotModel, cfg: WBQPConfig, q: torch.Tensor,
                    v: torch.Tensor, contact: torch.Tensor,
                    q_des: torch.Tensor, v_des: torch.Tensor,
                    f_des: torch.Tensor) -> torch.Tensor:
    """Joint torques [B, nj] from the whole-body QP of each scenario.

    q [B, nq], v [B, nv]; contact [B, E] bool, scheduled AND measured (the
    stationary-contact rows of a foot apply only when both hold); q_des,
    v_des the IK targets; f_des [B, E, 3] the MPC force targets."""
    return torques_and_sweeps(model, cfg, q, v, contact, q_des, v_des,
                              f_des)[0]


def torques_and_sweeps(model: RobotModel, cfg: WBQPConfig, q: torch.Tensor,
                       v: torch.Tensor, contact: torch.Tensor,
                       q_des: torch.Tensor, v_des: torch.Tensor,
                       f_des: torch.Tensor):
    """:func:`compute_torques` with the QP's sweeps: (tau [B, nj], the
    interior-point sweeps taken [B], ``cfg.ipm_iters`` where it stopped on
    its cap)."""
    nv, nj, E = model.nv, model.num_joints, model.num_ee
    dtype, dev = q.dtype, q.device
    B = q.shape[0]
    n = nv + 3 * E

    M, h, J, _, Jdot_v = rbd.dynamics_terms(model, q, v)
    cm = contact.to(dtype)                                     # [B, E]
    zeros = torch.zeros(B, 3 * E, nv, dtype=dtype, device=dev)

    # ---------------- equalities ------------------------------------------
    # floating-base dynamics: M_f qdd - sum_e J_e^T[:6] lam_e = -h_f
    JtF = -(J[..., :6] * cm[..., None, None]).permute(0, 3, 1, 2)
    A_dyn = torch.cat([M[:, :6], JtF.reshape(B, 6, 3 * E)], dim=-1)
    # stationary contacts: J_e qdd = -Jdot v - alpha J v (masked rows)
    Jv = (J @ v[:, None, :, None])[..., 0]                     # [B, E, 3]
    A_con = torch.cat([(J * cm[..., None, None]).reshape(B, 3 * E, nv),
                       torch.zeros(B, 3 * E, 3 * E, dtype=dtype, device=dev)],
                      dim=-1)
    b_con = ((-Jdot_v - cfg.contact_damp * Jv) * cm[..., None]).reshape(B, -1)
    # swing legs: pin lambda_e = 0 instead (their contact rows are masked)
    sw = torch.repeat_interleave(1.0 - cm, 3, dim=-1)          # [B, 3E]
    A_lam = torch.cat([zeros, torch.diag_embed(sw)], dim=-1)
    A = torch.cat([A_dyn, A_con, A_lam], dim=-2)
    b = torch.cat([-h[:, :6], b_con, torch.zeros_like(b_con)], dim=-1)

    # ---------------- inequalities ----------------------------------------
    # torque limits: tau = M_a qdd + h_a - sum J^T[6:] lam in [-bound, bound]
    Jt_a = (J[..., 6:] * cm[..., None, None]).permute(0, 3, 1, 2)
    T_rows = torch.cat([M[:, 6:], -Jt_a.reshape(B, nj, 3 * E)], dim=-1)
    G_tau = torch.cat([T_rows, -T_rows], dim=-2)
    tb = cfg.torque_bound
    h_tau = torch.cat([tb - h[:, 6:], tb + h[:, 6:]], dim=-1)
    # friction pyramid + fz >= 0 on stance feet (masked for swing)
    mu = cfg.friction_coef
    pyr = const(((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu),
                 (0.0, -1.0, -mu), (0.0, 0.0, -1.0)), dtype, dev)
    G_fr = torch.cat([torch.zeros(B, 5 * E, nv, dtype=dtype, device=dev),
                      _block_diag(pyr * cm[..., None, None])], dim=-1)
    G = torch.cat([G_tau, G_fr], dim=-2)
    h_vec = torch.cat([h_tau, torch.zeros(B, 5 * E, dtype=dtype, device=dev)],
                      dim=-1)

    # ---------------- costs -----------------------------------------------
    qdd_des_j = (cfg.kp_joint * (q_des[:, 7:] - q[:, 7:])
                 + cfg.kd_joint * (v_des[:, 6:] - v[:, 6:]))
    base_pos_err = q_des[:, 0:3] - q[:, 0:3]
    base_ang_err = quat_ops.log3(quat_ops.multiply(
        quat_ops.conjugate(q[:, 3:7]), quat_ops.normalize(q_des[:, 3:7])))
    qdd_des = torch.cat([
        cfg.kp_base_pos * base_pos_err
        + cfg.kd_base_pos * (v_des[:, 0:3] - v[:, 0:3]),
        cfg.kp_base_ang * base_ang_err
        + cfg.kd_base_ang * (v_des[:, 3:6] - v[:, 3:6]),
        qdd_des_j], dim=-1)
    wt = const((cfg.torso_weight,) * 6 + (cfg.leg_weight,) * nj, dtype, dev)
    wf = const((cfg.force_weight,) * (3 * E), dtype, dev)
    H = (torch.diag(torch.cat([wt, wf]))
         + 1e-6 * torch.eye(n, dtype=dtype, device=dev)).expand(B, n, n)
    qlin = torch.cat([-wt * qdd_des, -wf * f_des.reshape(B, -1)], dim=-1)

    sol = pdip.solve(H, qlin, A, b, G, h_vec, iters=cfg.ipm_iters, tol=1e-8)
    qdd = sol.x[:, :nv]
    lam = sol.x[:, nv:].reshape(B, E, 3) * cm[..., None]

    # torque recovery by inverse dynamics
    tau = ((M[:, 6:] @ qdd[..., None])[..., 0] + h[:, 6:]
           - torch.einsum('beiv,bei->bv', J[..., 6:], lam))
    return torch.clamp(tau, -tb, tb), sol.iters

