"""Single-rigid-body model (port of ``bilevel_gait_gen_tpu/models/srb.py``).

manifold state [13]: [p(3), h_lin(3), quat_xyzw(4), w(3)]
tangent  state [12]: [p(3), h_lin(3), log3(quat)(3), w(3)]

States and spline variables carry any number of leading batch dimensions;
``SRBParams`` is shared by every scenario and has none.
"""
from __future__ import annotations

import dataclasses

import torch

from . import rbd
from .rbd import RobotModel
from . import quat as quat_ops
from . import spline
from . import jnp_compat as jc
from .config import MPCConfig
from .consts import const


def gravity(dtype: torch.dtype, device=None) -> torch.Tensor:
    """(0, 0, -9.81); ``device`` None means the GPU."""
    return const((0.0, 0.0, -9.81), dtype, device)


@dataclasses.dataclass(frozen=True)
class SRBParams:
    """Constant physical parameters (see the JAX ``SRBParams``)."""
    mass: torch.Tensor            # scalar
    inertia: torch.Tensor         # [3, 3] composite inertia at nominal q
    inertia_inv: torch.Tensor     # [3, 3]
    hip_offset: torch.Tensor      # [E, 2] COM -> EE-box centre, margins in
    com_offset: torch.Tensor      # [3] base origin -> COM, body frame
    hip_offset_raw: torch.Tensor  # [E, 2] COM -> hip, no margins


def make_srb_params(model: RobotModel, nominal_q: torch.Tensor,
                    box_x_margin: float = 0.025,
                    box_y_margin: float = 0.1) -> SRBParams:
    """SRB constants from the full model at a nominal configuration [nq]."""
    dtype = nominal_q.dtype
    Ir = rbd.composite_inertia_about_com(model, nominal_q).to(dtype)
    hips = rbd.hip_positions(model, nominal_q)
    com = rbd.com_position(model, nominal_q)
    R0 = quat_ops.to_matrix(quat_ops.normalize(nominal_q[3:7]))
    com_offset = R0.T @ (com - nominal_q[0:3])
    off = hips[:, :2] - com[None, :2]
    off_x = off[:, 0] + box_x_margin
    off_y = off[:, 1] + torch.sign(off[:, 1]) * box_y_margin
    return SRBParams(
        mass=model.total_mass.to(dtype),
        inertia=Ir,
        inertia_inv=torch.linalg.inv(Ir).to(dtype),
        hip_offset=torch.stack([off_x, off_y], dim=-1).to(dtype),
        com_offset=com_offset.to(dtype),
        hip_offset_raw=off.to(dtype),
    )


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M [3, 3] times v [..., 3]."""
    return jc.matvec(M, v)


def reconstruct_state(params: SRBParams, q: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """SRB manifold state [..., 13] from the full robot (q, v)."""
    quat = quat_ops.normalize(q[..., 3:7])
    R = quat_ops.to_matrix(quat)
    c_world = (R @ params.com_offset[:, None])[..., 0]
    p = q[..., 0:3] + c_world
    omega_world = (R @ v[..., 3:6, None])[..., 0]
    v_com = v[..., 0:3] + torch.linalg.cross(omega_world, c_world)
    h = params.mass * v_com
    w = (R @ _mv(params.inertia, v[..., 3:6])[..., None])[..., 0]
    return torch.cat([p, h, quat, w], dim=-1)


def manifold_to_tangent(x_man: torch.Tensor) -> torch.Tensor:
    return torch.cat([x_man[..., 0:6], quat_ops.log3(x_man[..., 6:10]),
                      x_man[..., 10:13]], dim=-1)


def tangent_to_manifold(x_tan: torch.Tensor) -> torch.Tensor:
    return torch.cat([x_tan[..., 0:6], quat_ops.exp3(x_tan[..., 6:9]),
                      x_tan[..., 9:12]], dim=-1)


def dynamics(params: SRBParams, x_tan: torch.Tensor,
             f_nodes: torch.Tensor, footholds: torch.Tensor,
             bounds: torch.Tensor, t: torch.Tensor,
             cfg: MPCConfig) -> torch.Tensor:
    """Continuous tangent-state derivative [..., 12].

    x_tan [..., 12], f_nodes [..., E, S, F-1, 3, 2], footholds
    [..., E, S+1, 2], bounds [..., E, P+1], t [...]; differentiable in every
    argument, the phase boundaries included."""
    p = x_tan[..., 0:3]
    h = x_tan[..., 3:6]
    w = x_tan[..., 9:12]
    forces = spline.forces_all(bounds, f_nodes, t, cfg.num_force_polys)
    if cfg.force_carrier:
        forces = forces + spline.carrier_forces(
            bounds, t, params.mass * 9.81, cfg.carrier_ramp)
    feet = spline.foot_positions_all(bounds, footholds, t,
                                     cfg.swing_height, cfg.foot_offset)
    pdot = h / params.mass
    g = gravity(x_tan.dtype, x_tan.device)
    hdot = params.mass * g + torch.sum(forces, dim=-2)
    qdot = _mv(params.inertia_inv, w)
    wdot = (-torch.linalg.cross(w, _mv(params.inertia, w))
            + torch.sum(torch.linalg.cross(feet - p[..., None, :], forces,
                                           dim=-1), dim=-2))
    return torch.cat([pdot, hdot, qdot, wdot], dim=-1)


def discrete_step(params: SRBParams, x_tan: torch.Tensor,
                  f_nodes: torch.Tensor, footholds: torch.Tensor,
                  bounds: torch.Tensor, t: torch.Tensor, dt: float,
                  cfg: MPCConfig) -> torch.Tensor:
    """One integration step ("euler", the reference's production path, or
    "rk2")."""
    k1 = dynamics(params, x_tan, f_nodes, footholds, bounds, t, cfg)
    if cfg.integrator == "rk2":
        k2 = dynamics(params, x_tan + 0.5 * dt * k1, f_nodes, footholds,
                      bounds, t + 0.5 * dt, cfg)
        return x_tan + dt * k2
    return x_tan + dt * k1


def linearize(params: SRBParams, x_tan: torch.Tensor, f_nodes: torch.Tensor,
              footholds: torch.Tensor, u_unravel, u_flat: torch.Tensor,
              bounds: torch.Tensor, t: torch.Tensor, cfg: MPCConfig):
    """Continuous-time (A, B, C) with xdot ~= A x + B u + C, by forward-mode
    autodiff of :func:`dynamics`.

    x_tan [B, 12], u_flat [B, n_u], bounds [B, E, P+1], t [B] ->
    A [B, 12, 12], B [B, 12, n_u], C [B, 12]; without the leading dimension
    the result has none either.  ``u_unravel`` maps the flat input vector
    back to (f_nodes, footholds); A is taken at the passed f_nodes and
    footholds, B through ``u_flat``."""
    def one(x, fn, fh, u, b, tt):
        def f_of_x(xx):
            return dynamics(params, xx, fn, fh, b, tt, cfg)

        def f_of_u(uu):
            return dynamics(params, x, *u_unravel(uu), b, tt, cfg)

        A = torch.func.jacfwd(f_of_x)(x)
        Bm = torch.func.jacfwd(f_of_u)(u)
        return A, Bm, f_of_x(x) - A @ x - Bm @ u

    args = (x_tan, f_nodes, footholds, u_flat, bounds, t)
    if x_tan.ndim == 1:
        return one(*args)
    return torch.func.vmap(one)(*args)
