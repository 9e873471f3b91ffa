"""MIT Mini-Cheetah quadruped model for the PyTorch port (port of
``bilevel_gait_gen_tpu/models/mini_cheetah.py``; published parameters,
built programmatically).

Second quadruped family (the reference carries mini_cheetah URDFs,
models/mini_cheetah/mini_cheetah_simple_v2.urdf).  EE order FL, FR, HL, HR
to match the trot pairing convention used for the A1 (diagonal pairs
FR+HL / FL+HR).
"""
from __future__ import annotations

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel

HIP_X = 0.19
HIP_Y = 0.049
ABDUCT_TO_THIGH_Y = 0.062
THIGH_LEN = 0.209
SHANK_TO_FOOT = 0.195

BODY = dict(m=3.3, com=(0.0, 0.0, 0.0),
            I=((0.011253, 0, 0), (0, 0.036203, 0), (0, 0, 0.042673)))


def _abduct(sy):
    return dict(m=0.54, com=(0.0, sy * 0.036, 0.0),
                I=((0.000381, sy * 0.000058, 4.5e-07),
                   (sy * 0.000058, 0.00056, sy * 9.5e-07),
                   (4.5e-07, sy * 9.5e-07, 0.000444)))


def _thigh(sy):
    return dict(m=0.634, com=(0.0, sy * 0.016, -0.02),
                I=((0.001983, sy * 0.000245, 1.3e-05),
                   (sy * 0.000245, 0.002103, sy * 1.5e-06),
                   (1.3e-05, sy * 1.5e-06, 0.000508)))


SHANK = dict(m=0.064, com=(0.0, 0.0, -0.209),
             I=((0.000245, 0, 0), (0, 0.000248, 0), (0, 0, 6e-06)))

LEGS = ("FL", "FR", "HL", "HR")
STAND_JOINTS = (0.0, -0.8, 1.6)   # abduct, thigh, knee (y-axis sign: -1)
STAND_HEIGHT = 0.29
EFFORT = 17.0
VEL_LIM = 40.0


def make_mini_cheetah(device=None) -> RobotModel:
    """The Mini Cheetah model; its tensors are float32 on ``device``
    (default: the GPU)."""
    device = resolve_device(device)
    parent = [0]
    jtrans = [np.zeros(3)]
    jaxis = [np.array([1.0, 0, 0])]
    inert = [(BODY["m"], np.array(BODY["com"]), np.array(BODY["I"]))]
    ee_link, ee_off, hip_link = [], [], []
    joint_names = []

    def add(par, trans, axis, body, joint_name):
        parent.append(par)
        jtrans.append(np.array(trans))
        jaxis.append(np.array(axis))
        inert.append((body["m"], np.array(body["com"]), np.array(body["I"])))
        joint_names.append(joint_name)
        return len(parent) - 1

    for leg in LEGS:
        sx = 1.0 if leg[0] == "F" else -1.0
        sy = 1.0 if leg[1] == "L" else -1.0
        low = leg.lower()
        ab_i = add(0, [sx * HIP_X, sy * HIP_Y, 0.0], [1.0, 0.0, 0.0],
                   _abduct(sy), f"torso_to_abduct_{low}_j")
        hip_link.append(ab_i)
        # URDF axis "0 -1 0" on the thigh and the knee
        th_i = add(ab_i, [0.0, sy * ABDUCT_TO_THIGH_Y, 0.0], [0.0, -1.0, 0.0],
                   _thigh(sy), f"abduct_to_thigh_{low}_j")
        sh_i = add(th_i, [0.0, 0.0, -THIGH_LEN], [0.0, -1.0, 0.0], SHANK,
                   f"thigh_to_knee_{low}_j")
        ee_link.append(sh_i)
        ee_off.append(np.array([0.0, 0.0, -SHANK_TO_FOOT]))

    nj = len(parent) - 1

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return RobotModel(
        parent=tuple(parent),
        ee_link=tuple(ee_link),
        hip_link=tuple(hip_link),
        ee_names=tuple(f"{leg}_FOOT" for leg in LEGS),
        joint_names=tuple(joint_names),
        joint_trans=f32(np.stack(jtrans)),
        joint_axis=f32(np.stack(jaxis)),
        mass=f32([x[0] for x in inert]),
        com=f32(np.stack([x[1] for x in inert])),
        inertia=f32(np.stack([x[2] for x in inert])),
        ee_offset=f32(np.stack(ee_off)),
        joint_lower=f32(np.full(nj, -2 * np.pi)),
        joint_upper=f32(np.full(nj, 2 * np.pi)),
        effort_limit=f32(np.full(nj, EFFORT)),
        velocity_limit=f32(np.full(nj, VEL_LIM)),
    )


def stand_config() -> np.ndarray:
    """Nominal standing configuration [p(3), quat_xyzw(4), joints(12)]."""
    q = [0.0, 0.0, STAND_HEIGHT, 0.0, 0.0, 0.0, 1.0]
    for _ in LEGS:
        q.extend(STAND_JOINTS)
    return np.array(q, dtype=np.float32)
