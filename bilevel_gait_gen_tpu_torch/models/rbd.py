"""Rigid-body kinematics in PyTorch (port of the forward-kinematics and
composite-inertia part of ``bilevel_gait_gen_tpu/models/rbd.py``).

Conventions as in the JAX package: q = [p_base(3), quat_xyzw(4),
q_joints(nj)], link 0 is the floating base.  Configurations may carry any
number of leading batch dimensions.  Model tensors stay float32, as the JAX
package's numpy arrays do, and are promoted to the configuration's dtype
where they meet it, so a float64 run sees the same float32-rounded
parameters on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch.ops import quat as quat_ops


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Kinematic tree: static topology tuples plus per-link tensors."""
    parent: Tuple[int, ...]
    ee_link: Tuple[int, ...]
    hip_link: Tuple[int, ...]
    ee_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]

    joint_trans: torch.Tensor     # [L, 3] joint origin in parent frame
    joint_axis: torch.Tensor      # [L, 3] revolute axis (row 0 unused)
    mass: torch.Tensor            # [L]
    com: torch.Tensor             # [L, 3] link COM in link frame
    inertia: torch.Tensor         # [L, 3, 3] about the link COM
    ee_offset: torch.Tensor       # [E, 3] end-effector point in its link
    joint_lower: torch.Tensor     # [nj]
    joint_upper: torch.Tensor     # [nj]
    effort_limit: torch.Tensor    # [nj]
    velocity_limit: torch.Tensor  # [nj]

    @property
    def num_links(self) -> int:
        return len(self.parent)

    @property
    def num_joints(self) -> int:
        return len(self.parent) - 1

    @property
    def nv(self) -> int:
        return 6 + self.num_joints

    @property
    def nq(self) -> int:
        return 7 + self.num_joints

    @property
    def num_ee(self) -> int:
        return len(self.ee_link)

    @property
    def total_mass(self) -> torch.Tensor:
        """Sum of the link masses, accumulated in float32 in link order:
        the JAX package's float32 reduction gives this value, where
        ``torch.sum`` may round the last bit differently."""
        acc = np.float32(0.0)
        for v in self.mass.tolist():
            acc = np.float32(acc + np.float32(v))
        return torch.tensor(acc, dtype=torch.float32, device=self.mass.device)


def fk_links(model: RobotModel,
             q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World rotation [..., L, 3, 3] and position [..., L, 3] of every
    link frame."""
    base_p = q[..., 0:3]
    base_R = quat_ops.to_matrix(quat_ops.normalize(q[..., 3:7]))
    qj = q[..., 7:]
    trans = model.joint_trans.to(q.dtype)
    axes = model.joint_axis.to(q.dtype)
    Rs = [base_R]
    ps = [base_p]
    for i in range(1, model.num_links):
        par = model.parent[i]
        Rp, pp = Rs[par], ps[par]
        ps.append(pp + (Rp @ trans[i][:, None])[..., 0])
        Rs.append(Rp @ _axis_angle_matrix(axes[i], qj[..., i - 1]))
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def _axis_angle_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a unit axis [3] by angle [...]."""
    K = quat_ops.skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def ee_positions(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[..., E, 3] world positions of the end-effector points."""
    Rs, ps = fk_links(model, q)
    links = list(model.ee_link)
    R_ee = Rs[..., links, :, :]
    p_ee = ps[..., links, :]
    return p_ee + torch.einsum('...eij,ej->...ei', R_ee,
                                model.ee_offset.to(q.dtype))


def hip_positions(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[..., E, 3] world positions of the hip joint frames."""
    _, ps = fk_links(model, q)
    return ps[..., list(model.hip_link), :]


def com_position(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Whole-body COM in the world frame, [..., 3]."""
    Rs, ps = fk_links(model, q)
    coms = ps + torch.einsum('...lij,lj->...li', Rs, model.com.to(q.dtype))
    return (torch.sum(model.mass[:, None] * coms, dim=-2)
            / model.total_mass)


def composite_inertia_about_com(model: RobotModel,
                                q: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotational inertia of the whole robot about its COM,
    world axes."""
    Rs, ps = fk_links(model, q)
    coms = ps + torch.einsum('...lij,lj->...li', Rs, model.com.to(q.dtype))
    com = torch.sum(model.mass[:, None] * coms, dim=-2) / model.total_mass
    Iw = torch.einsum('...lij,ljk,...lmk->...lim', Rs,
                      model.inertia.to(q.dtype), Rs)
    r = coms - com[..., None, :]
    r2 = torch.sum(r * r, dim=-1)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    par = model.mass[:, None, None] * (
        r2[..., None, None] * eye - torch.einsum('...li,...lj->...lij', r, r))
    return torch.sum(Iw + par, dim=-3)
