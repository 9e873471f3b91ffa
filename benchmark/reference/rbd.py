"""Rigid-body kinematics and dynamics in PyTorch (port of
``bilevel_gait_gen_tpu/models/rbd.py``).

Conventions as in the JAX package: q = [p_base(3), quat_xyzw(4),
q_joints(nj)], v = [v_base_world(3), omega_base_body(3), qd_joints(nj)],
link 0 is the floating base.  Configurations may carry any number of leading
batch dimensions.  Model tensors stay float32, as the JAX package's numpy
arrays do, and are promoted to the configuration's dtype where they meet it,
so a float64 run sees the same float32-rounded parameters on both sides.

The JAX package takes the Jacobians with ``jax.jacfwd`` through FK in the
tangent space and the bias forces from the Lagrangian with ``jax.jvp`` and
``jax.grad``.  Here both are closed forms of the same quantities:

* geometric Jacobians: the base columns are the identity (linear) and
  ``-[x - p_base]_x R_base`` (body angular velocity); a revolute joint's
  column is ``a_k x (x - p_k)`` for a point x on a descendant of joint k,
  a_k its world axis;
* the velocity-product accelerations (the link accelerations at
  ``v' = 0``, the flow along which the JAX package differentiates) by the
  chain sums of the Newton-Euler recursion, and from them the bias forces
  as sum_l J_l^T (Newton-Euler force of link l).

That sum is the physical bias.  The JAX package's Lagrangian identity
h = Mdot v - dT/dq + g with tangent-space derivatives holds the body angular
velocity as if it were a coordinate rate, and so leaves out the base's
gyroscopic term omega_body x dT/domega_body (the Euler-Poincare term of
SO(3)); :func:`bias_forces` subtracts it, so that it returns the reference's
h exactly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from . import quat as quat_ops
from . import jnp_compat as jc
from .consts import const

GRAVITY = (0.0, 0.0, -9.81)


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
    # sum of the link masses, float32 on the model's device; computed when
    # the model is made (None there), so that reading it copies nothing
    total_mass: torch.Tensor | None = None

    def __post_init__(self):
        if self.total_mass is None:
            # accumulated in float32 in link order: the JAX package's float32
            # reduction gives this value, where torch.sum may round the last
            # bit differently
            acc = np.float32(0.0)
            for m in self.mass.tolist():
                acc = np.float32(acc + np.float32(m))
            object.__setattr__(self, "total_mass", torch.tensor(
                acc, dtype=torch.float32, device=self.mass.device))

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


def _index(indices: Tuple[int, ...], device) -> torch.Tensor:
    """Link or joint indices as a tensor on ``device``, built once (a read
    through a Python list would build it on the host at every call)."""
    return const(indices, torch.int64, device)


@functools.cache
def _depth_levels(parent: Tuple[int, ...]):
    """The tree by depth below the base: for each depth, (its links in link
    order, the position of each one's parent among the links one level up);
    and the position of every link in the base-then-depth order."""
    depth = [0] * len(parent)
    for i in range(1, len(parent)):
        depth[i] = depth[parent[i]] + 1
    levels, above = [], [0]
    for d in range(1, max(depth, default=0) + 1):
        links = tuple(i for i in range(len(parent)) if depth[i] == d)
        levels.append((links, tuple(above.index(parent[i]) for i in links)))
        above = list(links)
    order = [0] + [i for links, _ in levels for i in links]
    return tuple(levels), tuple(order.index(i) for i in range(len(parent)))


def fk_links(model: RobotModel,
             q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World rotation [..., L, 3, 3] and position [..., L, 3] of every
    link frame.  The joints' rotations are formed together, then the tree
    is walked one depth level at a time."""
    dtype, dev = q.dtype, q.device
    Rs = [quat_ops.to_matrix(quat_ops.normalize(q[..., 3:7]))[..., None, :, :]]
    ps = [q[..., None, 0:3]]
    # Rodrigues rotation of every joint about its unit axis
    K = quat_ops.skew(model.joint_axis[1:].to(dtype))           # [nj, 3, 3]
    qj = q[..., 7:]
    s = torch.sin(qj)[..., None, None]
    c = torch.cos(qj)[..., None, None]
    eye = torch.eye(3, dtype=dtype, device=dev)
    R_joint = eye + s * K + (1.0 - c) * (K @ K)                 # [..., nj, 3, 3]
    trans = model.joint_trans.to(dtype)
    levels, position = _depth_levels(model.parent)
    for links, parents in levels:
        idx = _index(links, dev)
        up = _index(parents, dev)
        Rp = Rs[-1].index_select(-3, up)
        ps.append(ps[-1].index_select(-2, up)
                  + (Rp @ trans.index_select(0, idx)[:, :, None])[..., 0])
        Rs.append(Rp @ R_joint.index_select(
            -3, _index(tuple(i - 1 for i in links), dev)))
    pos = _index(position, dev)
    return (torch.cat(Rs, dim=-3).index_select(-3, pos),
            torch.cat(ps, dim=-2).index_select(-2, pos))


def ee_positions(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[..., E, 3] world positions of the end-effector points."""
    Rs, ps = fk_links(model, q)
    return _ee_points(model, Rs, ps)


def _ee_points(model: RobotModel, Rs: torch.Tensor,
               ps: torch.Tensor) -> torch.Tensor:
    idx = _index(model.ee_link, ps.device)
    return ps.index_select(-2, idx) + torch.einsum(
        '...eij,ej->...ei', Rs.index_select(-3, idx),
        model.ee_offset.to(ps.dtype))


def hip_positions(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[..., E, 3] world positions of the hip joint frames."""
    _, ps = fk_links(model, q)
    return ps.index_select(-2, _index(model.hip_link, ps.device))


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


# ----------------------------------------------------------------------------
# Tangent space: q boxplus dq with dq = [dp_world(3), omega_body(3), dqj]
# ----------------------------------------------------------------------------

def integrate_config(q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """q boxplus dq, [..., nq]."""
    return torch.cat([q[..., 0:3] + dq[..., 0:3],
                      quat_ops.box_plus(q[..., 3:7], dq[..., 3:6]),
                      q[..., 7:] + dq[..., 6:]], dim=-1)


# ----------------------------------------------------------------------------
# Geometric Jacobians, closed form
# ----------------------------------------------------------------------------

@functools.cache
def _chain(parent: Tuple[int, ...]) -> tuple:
    """[L][L]: 1.0 where link k is link l or one of its ancestors."""
    rows = []
    for link in range(len(parent)):
        row = [0.0] * len(parent)
        k = link
        row[k] = 1.0
        while k != 0:
            k = parent[k]
            row[k] = 1.0
        rows.append(tuple(row))
    return tuple(rows)


def _joint_chain(model: RobotModel, links: Tuple[int, ...],
                 like: torch.Tensor) -> torch.Tensor:
    """[K, nj]: 1 where joint j moves link ``links[k]`` (joint j turns link
    j + 1)."""
    chain = _chain(model.parent)
    return const(tuple(chain[link][1:] for link in links), like.dtype,
                 like.device)


def _world_axes(model: RobotModel, Rs: torch.Tensor) -> torch.Tensor:
    """[..., nj, 3] world axes of the joints (a joint's axis is the same in
    its link's frame and in its parent's)."""
    return torch.einsum('...lij,lj->...li', Rs[..., 1:, :, :],
                        model.joint_axis[1:].to(Rs.dtype))


def _joint_columns(model: RobotModel, Rs: torch.Tensor, ps: torch.Tensor,
                   links: Tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """[..., K, 3, nj] joint columns of the linear Jacobians of the points
    x [..., K, 3] fixed on ``links``: a_j x (x - p_j) where joint j moves the
    link."""
    a = _world_axes(model, Rs)                                 # [..., nj, 3]
    r = x[..., :, None, :] - ps[..., None, 1:, :]              # [..., K, nj, 3]
    cols = torch.linalg.cross(a[..., None, :, :].expand_as(r), r)
    cols = cols * _joint_chain(model, links, x)[..., None]
    return cols.transpose(-1, -2)


def _point_jacobians(model: RobotModel, Rs: torch.Tensor, ps: torch.Tensor,
                     links: Tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """[..., K, 3, nv] linear Jacobians of the points x [..., K, 3] fixed on
    ``links``: the identity for the base's world velocity,
    -[x - p_base]_x R_base for its body angular velocity, then the joints."""
    R0 = Rs[..., None, 0, :, :]
    base_w = -quat_ops.skew(x - ps[..., None, 0, :]) @ R0
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand_as(base_w)
    return torch.cat([eye, base_w, _joint_columns(model, Rs, ps, links, x)],
                     dim=-1)


def _angular_jacobians(model: RobotModel, Rs: torch.Tensor) -> torch.Tensor:
    """[..., L, 3, nv] world angular-velocity Jacobians of every link."""
    L = model.num_links
    a = _world_axes(model, Rs)                                 # [..., nj, 3]
    cols = (a[..., None, :, :] * _joint_chain(model, tuple(range(L)),
                                              Rs)[..., None])  # [..., L, nj, 3]
    R0 = Rs[..., None, 0, :, :].expand(*Rs.shape[:-3], L, 3, 3)
    return torch.cat([torch.zeros_like(R0), R0, cols.transpose(-1, -2)],
                     dim=-1)


def ee_joint_jacobians(model: RobotModel, q: torch.Tensor):
    """(feet [..., E, 3], the joint columns of their Jacobians
    [..., E, 3, nj]) from one FK: what an inverse-kinematics step needs."""
    Rs, ps = fk_links(model, q)
    feet = _ee_points(model, Rs, ps)
    return feet, _joint_columns(model, Rs, ps, model.ee_link, feet)


def ee_jacobians(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[..., E, 3, nv] linear Jacobians of the end-effector points."""
    Rs, ps = fk_links(model, q)
    return _point_jacobians(model, Rs, ps, model.ee_link,
                            _ee_points(model, Rs, ps))


# ----------------------------------------------------------------------------
# Dynamics: mass matrix, bias forces
# ----------------------------------------------------------------------------

def _link_coms(model: RobotModel, Rs: torch.Tensor,
               ps: torch.Tensor) -> torch.Tensor:
    return ps + torch.einsum('...lij,lj->...li', Rs, model.com.to(ps.dtype))


def _world_inertia(model: RobotModel, Rs: torch.Tensor) -> torch.Tensor:
    """[..., L, 3, 3] R_l I_l R_l^T."""
    return torch.einsum('...lij,ljk,...lmk->...lim', Rs,
                        model.inertia.to(Rs.dtype), Rs)


def _velocity_products(model: RobotModel, Rs: torch.Tensor, ps: torch.Tensor,
                       v: torch.Tensor):
    """Link angular velocities w, and the angular and origin accelerations
    alpha and acc at v' = 0 (the motion with constant generalized velocity,
    along which the JAX package takes its derivatives), each [..., L, 3]:

        w_l     = R_base omega + sum_{j moves l} a_j qd_j
        alpha_l = sum_{j moves l} w_j x a_j qd_j
        acc_l   = sum_{j moves l} alpha_par x d_j + w_par x (w_par x d_j)

    with d_j = p_j - p_par(j); the base's own world angular velocity is
    constant along that motion, so alpha and acc start from 0 there."""
    L = model.num_links
    chain = _joint_chain(model, tuple(range(L)), v)            # [L, nj]
    rate = _world_axes(model, Rs) * v[..., 6:, None]           # [..., nj, 3]
    w0 = (Rs[..., 0, :, :] @ v[..., 3:6, None])[..., 0]
    w = w0[..., None, :] + torch.einsum('lj,...ji->...li', chain, rate)
    alpha = torch.einsum('lj,...ji->...li', chain,
                         torch.linalg.cross(w[..., 1:, :], rate))
    par = _index(model.parent[1:], v.device)
    w_par = w.index_select(-2, par)
    d = ps[..., 1:, :] - ps.index_select(-2, par)
    edge = (torch.linalg.cross(alpha.index_select(-2, par), d)
            + torch.linalg.cross(w_par, torch.linalg.cross(w_par, d)))
    acc = torch.einsum('lj,...ji->...li', chain, edge)
    return w, alpha, acc


def _point_accelerations(w, alpha, acc, ps, x):
    """Velocity-product acceleration of points x fixed on the links whose
    (w, alpha, acc, p) are given, all [..., K, 3]."""
    r = x - ps
    return (acc + torch.linalg.cross(alpha, r)
            + torch.linalg.cross(w, torch.linalg.cross(w, r)))


def _mass_matrix(model: RobotModel, Rs, ps, coms) -> tuple:
    """(M [..., nv, nv], Jc, Jw, Iw): sum_l m_l Jc_l^T Jc_l + Jw_l^T Iw_l Jw_l
    over the links' COM and angular Jacobians."""
    dtype = ps.dtype
    Jc = _point_jacobians(model, Rs, ps, tuple(range(model.num_links)), coms)
    Jw = _angular_jacobians(model, Rs)
    Iw = _world_inertia(model, Rs)
    M = (torch.einsum('l,...liv,...liw->...vw', model.mass.to(dtype), Jc, Jc)
         + torch.einsum('...liv,...lij,...ljw->...vw', Jw, Iw, Jw))
    return 0.5 * (M + M.mT), Jc, Jw, Iw


def mass_matrix(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix M(q) [..., nv, nv]."""
    Rs, ps = fk_links(model, q)
    return _mass_matrix(model, Rs, ps, _link_coms(model, Rs, ps))[0]


def _dynamics(model: RobotModel, Rs, ps, v, products):
    """(M, h) at the configuration of (Rs, ps) and velocity v, whose
    :func:`_velocity_products` are ``products``; h is the reference's
    Lagrangian h (module docstring)."""
    dtype = v.dtype
    coms = _link_coms(model, Rs, ps)
    M, Jc, Jw, Iw = _mass_matrix(model, Rs, ps, coms)
    w, alpha, acc = products
    a_c = _point_accelerations(w, alpha, acc, ps, coms)
    force = model.mass.to(dtype)[:, None] * (a_c - const(GRAVITY, dtype,
                                                         v.device))
    Iw_w = jc.matvec(Iw, w)
    torque = jc.matvec(Iw, alpha) + torch.linalg.cross(w, Iw_w)
    h = (torch.einsum('...liv,...li->...v', Jc, force)
         + torch.einsum('...liv,...li->...v', Jw, torque))
    # the Lagrangian identity's h lacks omega x dT/domega on the base rows
    Mv = (M @ v[..., None])[..., 0]
    gyro = torch.linalg.cross(v[..., 3:6], Mv[..., 3:6])
    h = torch.cat([h[..., 0:3], h[..., 3:6] - gyro, h[..., 6:]], dim=-1)
    return M, h


def bias_forces(model: RobotModel, q: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Nonlinear effects h(q, v) [..., nv] with M qdd + h = tau + J^T f: the
    JAX package's h = Mdot v - dT/dq + g in its tangent convention."""
    Rs, ps = fk_links(model, q)
    return _dynamics(model, Rs, ps, v,
                     _velocity_products(model, Rs, ps, v))[1]


def _ee_bias(model: RobotModel, Rs, ps, products):
    idx = _index(model.ee_link, ps.device)
    w, alpha, acc = (t.index_select(-2, idx) for t in products)
    return _point_accelerations(w, alpha, acc, ps.index_select(-2, idx),
                                _ee_points(model, Rs, ps))


def dynamics_terms(model: RobotModel, q: torch.Tensor, v: torch.Tensor):
    """The terms the whole-body QP and the physics step need, from one FK:
    (M [..., nv, nv], h [..., nv], J [..., E, 3, nv] the end-effector
    Jacobians, feet [..., E, 3] their positions, Jdot v [..., E, 3])."""
    Rs, ps = fk_links(model, q)
    products = _velocity_products(model, Rs, ps, v)
    M, h = _dynamics(model, Rs, ps, v, products)
    feet = _ee_points(model, Rs, ps)
    J = _point_jacobians(model, Rs, ps, model.ee_link, feet)
    return M, h, J, feet, _ee_bias(model, Rs, ps, products)
