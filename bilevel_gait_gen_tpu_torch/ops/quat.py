"""Quaternion and SO(3) manifold/tangent maps (PyTorch port of
``bilevel_gait_gen_tpu/ops/quat.py``).

Quaternions are (x, y, z, w).  Every function takes any number of leading
batch dimensions: a quaternion is ``[..., 4]``, a vector ``[..., 3]``.
"""
from __future__ import annotations

import torch

from bilevel_gait_gen_tpu_torch.utils import jnp_compat as jc

_EPS = 1e-12


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def identity(*, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (active rotation, R(q) @ v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R(q), [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ]
    return torch.stack(rows, dim=-2)


def log3(q: torch.Tensor) -> torch.Tensor:
    """SO(3) log map, quaternion -> rotation vector, smooth at identity
    (a series replaces theta/sin(theta/2) near 0, so gradients stay
    finite there)."""
    q = q * torch.sign(q[..., 3:4] + _EPS)     # short arc (w >= 0)
    v = q[..., :3]
    w = jc.clip(q[..., 3], -1.0, 1.0)
    s2 = torch.sum(v * v, dim=-1)
    small = s2 < 1e-8
    # guard the sqrt so its derivative never sees 0
    safe_s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = 2.0 * torch.atan2(safe_s, w)
    w_safe = jc.maximum(w, 0.5)
    series = 2.0 / w_safe * (1.0 - s2 / (3.0 * w_safe * w_safe))
    factor = torch.where(small, series, theta / safe_s)
    return factor[..., None] * v


def exp3(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) exp map, rotation vector -> quaternion, smooth at 0."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    small = theta < 1e-4
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([sinc_half[..., None] * omega, w[..., None]], dim=-1)


def box_minus(q: torch.Tensor, q_ref: torch.Tensor) -> torch.Tensor:
    """log3(q_ref^{-1} * q)."""
    return log3(multiply(conjugate(q_ref), q))


def box_plus(q_ref: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """q_ref * exp3(omega), renormalized."""
    return normalize(multiply(q_ref, exp3(omega)))


def skew(v: torch.Tensor) -> torch.Tensor:
    """[v]_x with [v]_x @ u = v x u, [..., 3, 3]."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], dim=-2)


def from_euler_zyx(rpy: torch.Tensor) -> torch.Tensor:
    """Quaternion from roll-pitch-yaw (XYZ intrinsic / ZYX extrinsic)."""
    r, p, y = (0.5 * rpy).unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def yaw(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
