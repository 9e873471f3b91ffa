"""Damped-least-squares inverse kinematics, batch first (port of
``bilevel_gait_gen_tpu/control/ik.py``).

``solve_ik`` matches the floating base to a pose and each foot to a target
with a fixed number of damped Gauss-Newton steps and a joint-limit clip;
``ik_velocities`` solves the velocity-level problem once.  Leading batch
dimensions are free.
"""
from __future__ import annotations

import torch

from . import rbd
from .rbd import RobotModel
from . import quat as quat_ops
from .pdip import spd_solve


def _damped_pinv_apply(J: torch.Tensor, r: torch.Tensor,
                       damping: float) -> torch.Tensor:
    """J^T (J J^T + damping I)^-1 r for J [..., k, n], r [..., k]."""
    eye = torch.eye(J.shape[-2], dtype=J.dtype, device=J.device)
    JJt = J @ J.mT + damping * eye
    # cuBLAS's batched GEMV, whose kernel changes with the batch count, kept
    # on purpose: the elementwise form moved the centroidal RTI's IK, and
    # chip_smoke.py phase 9's kernel check on it, past that check's cap; on
    # ops/kernels.bmv (utils/jnp_compat) phase 9 holds, but the closed-loop
    # harness's whole-controller card-vs-CPU check (phase 14) goes past its
    # limit (PERF.md §6)
    return (J.mT @ spd_solve(JJt, r)[..., None])[..., 0]


def solve_ik(model: RobotModel, base_pos: torch.Tensor,
             base_quat: torch.Tensor, feet_des: torch.Tensor,
             q_guess: torch.Tensor, *, iters: int = 15,
             damping: float = 1e-4) -> torch.Tensor:
    """Whole-body configuration [..., nq] tracking a base pose and foot
    positions: base_pos [..., 3], base_quat [..., 4] (xyzw), feet_des
    [..., E, 3], q_guess [..., nq].  The base part of the result is pinned
    exactly; the joints solve the foot targets."""
    lead = feet_des.shape[:-2]
    lower = model.joint_lower.to(q_guess.dtype)
    upper = model.joint_upper.to(q_guess.dtype)
    qj = q_guess[..., 7:]
    for _ in range(iters):
        q = torch.cat([base_pos, base_quat, qj], dim=-1)
        feet, J = rbd.ee_joint_jacobians(model, q)
        r = (feet_des - feet).reshape(*lead, -1)
        dq = _damped_pinv_apply(J.reshape(*lead, r.shape[-1], -1), r,
                                damping)
        qj = torch.minimum(upper, torch.maximum(lower, qj + dq))
    return torch.cat([base_pos, quat_ops.normalize(base_quat), qj], dim=-1)


def ik_velocities(model: RobotModel, q: torch.Tensor, base_vel: torch.Tensor,
                  base_omega: torch.Tensor, feet_vel: torch.Tensor,
                  damping: float = 1e-6) -> torch.Tensor:
    """Generalized velocity [..., nv] consistent with a base twist (world
    linear, body angular) and foot velocities [..., E, 3]:
    J_j qd_j = v_foot - J_base [v; w], damped."""
    lead = feet_vel.shape[:-2]
    J = rbd.ee_jacobians(model, q)                          # [..., E, 3, nv]
    base_tw = torch.cat([base_vel, base_omega], dim=-1)
    r = (feet_vel - (J[..., :6] @ base_tw[..., None, :, None])[..., 0]
         ).reshape(*lead, -1)
    Jj = J[..., 6:].reshape(*lead, r.shape[-1], -1)
    qd_j = _damped_pinv_apply(Jj, r, damping)
    return torch.cat([base_vel, base_omega, qd_j], dim=-1)
