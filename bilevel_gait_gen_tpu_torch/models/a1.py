"""Unitree A1 quadruped model for the PyTorch port (port of
``bilevel_gait_gen_tpu/models/a1.py``, whose make_a1 returns the JAX
``RobotModel`` and so cannot be shared).

Numeric parameters are the published Unitree A1 values (identical to the
a1_description URDF the reference loads; reference consumes them through
Pinocchio in mpc/models/model.cpp:14-37).  End-effector order follows the
reference config: FL, FR, RL, RR (apps/a1_configuration.yaml
`collision_frames`), giving the trot diagonal pairs FR+RL / FL+RR.
"""
from __future__ import annotations

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel
from bilevel_gait_gen_tpu_torch.models.urdf import _merge_inertia

# Leg geometry (meters)
HIP_X = 0.1805
HIP_Y = 0.047
HIP_TO_THIGH_Y = 0.0838
THIGH_LEN = 0.2
CALF_LEN = 0.2

# Link inertials: mass, com (link frame), inertia about com (link frame).
TRUNK = dict(m=6.0, com=(0.0, 0.0041, -0.0005),
             I=((0.0158533, -3.66e-05, -6.11e-05),
                (-3.66e-05, 0.0377999, -2.75e-05),
                (-6.11e-05, -2.75e-05, 0.0456542)))
IMU = dict(m=0.001, com=(0.0, 0.0, 0.0),
           I=((1e-4, 0, 0), (0, 1e-4, 0), (0, 0, 1e-4)))


def _hip(side):  # side = +1 left, -1 right (mirrors y products)
    return dict(m=0.696, com=(-0.003311, side * 0.000635, 3.1e-05),
                I=((0.000469246, side * -9.409e-06, -3.42e-07),
                   (side * -9.409e-06, 0.00080749, side * -4.66e-07),
                   (-3.42e-07, side * -4.66e-07, 0.000552929)))


def _rear_hip(side):
    return dict(m=0.696, com=(0.003311, side * 0.000635, 3.1e-05),
                I=((0.000469246, side * 9.409e-06, 3.42e-07),
                   (side * 9.409e-06, 0.00080749, side * -4.66e-07),
                   (3.42e-07, side * -4.66e-07, 0.000552929)))


def _thigh(side):
    return dict(m=1.013, com=(-0.003237, side * -0.022327, -0.027326),
                I=((0.005529065, side * 4.825e-06, 0.000343869),
                   (side * 4.825e-06, 0.005139339, side * 2.2448e-05),
                   (0.000343869, side * 2.2448e-05, 0.001367788)))


CALF = dict(m=0.166, com=(0.006435, 0.0, -0.107388),
            I=((0.002997972, 0.0, -0.000141163),
               (0.0, 0.003014022, 0.0),
               (-0.000141163, 0.0, 3.2426e-05)))
FOOT = dict(m=0.06, com=(0.0, 0.0, 0.0),
            I=((9.6e-06, 0, 0), (0, 9.6e-06, 0), (0, 0, 9.6e-06)))

JOINT_LOWER = (-0.802851455917, -1.0471975512, -2.69653369433)
JOINT_UPPER = (0.802851455917, 4.18879020479, -0.916297857297)
EFFORT = 33.5
VEL_LIM = 21.0

# Standing / nominal joint configuration (reference init_config,
# apps/a1_configuration.yaml:19-23: hip, thigh, calf per leg).
STAND_JOINTS = {
    "FL": (-0.02, 0.9, -1.6), "FR": (0.02, 0.9, -1.6),
    "RL": (0.02, 0.9, -1.6), "RR": (-0.02, 0.9, -1.6),
}
STAND_HEIGHT = 0.3

LEGS = ("FL", "FR", "RL", "RR")


def make_a1(device=None) -> RobotModel:
    """The A1 model; its tensors are float32 on ``device`` (the JAX make_a1
    keeps float32 numpy arrays, promoted where they meet the state)."""
    names = ["trunk"]
    parent = [0]
    jtrans = [np.zeros(3)]
    jaxis = [np.array([1.0, 0, 0])]
    inert = []

    # trunk + imu merged
    m0, c0, I0 = _merge_inertia(
        TRUNK["m"], np.array(TRUNK["com"]), np.array(TRUNK["I"]),
        IMU["m"], np.array(IMU["com"]), np.array(IMU["I"]))
    inert.append((m0, c0, I0))

    ee_link, ee_off, hip_link = [], [], []
    lower, upper = [], []
    for leg in LEGS:
        front = leg[0] == "F"
        left = leg[1] == "L"
        sx = 1.0 if front else -1.0
        sy = 1.0 if left else -1.0
        side = 1.0 if left else -1.0

        hip_i = len(names)
        names.append(f"{leg}_hip")
        parent.append(0)
        jtrans.append(np.array([sx * HIP_X, sy * HIP_Y, 0.0]))
        jaxis.append(np.array([1.0, 0, 0]))
        hip = _hip(side) if front else _rear_hip(side)
        inert.append((hip["m"], np.array(hip["com"]), np.array(hip["I"])))
        hip_link.append(hip_i)

        thigh_i = len(names)
        names.append(f"{leg}_thigh")
        parent.append(hip_i)
        jtrans.append(np.array([0.0, sy * HIP_TO_THIGH_Y, 0.0]))
        jaxis.append(np.array([0.0, 1.0, 0]))
        th = _thigh(side)
        inert.append((th["m"], np.array(th["com"]), np.array(th["I"])))

        calf_i = len(names)
        names.append(f"{leg}_calf")
        parent.append(thigh_i)
        jtrans.append(np.array([0.0, 0.0, -THIGH_LEN]))
        jaxis.append(np.array([0.0, 1.0, 0]))
        foot_pos = np.array([0.0, 0.0, -CALF_LEN])
        mc, cc, Ic = _merge_inertia(
            CALF["m"], np.array(CALF["com"]), np.array(CALF["I"]),
            FOOT["m"], foot_pos + np.array(FOOT["com"]), np.array(FOOT["I"]))
        inert.append((mc, cc, Ic))
        ee_link.append(calf_i)
        ee_off.append(foot_pos)

        lower.extend(JOINT_LOWER)
        upper.extend(JOINT_UPPER)

    nj = len(names) - 1

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return RobotModel(
        parent=tuple(parent),
        ee_link=tuple(ee_link),
        hip_link=tuple(hip_link),
        ee_names=tuple(f"{leg}_foot" for leg in LEGS),
        joint_names=tuple(f"{leg}_{part}_joint" for leg in LEGS
                          for part in ("hip", "thigh", "calf")),
        joint_trans=f32(np.stack(jtrans)),
        joint_axis=f32(np.stack(jaxis)),
        mass=f32(np.array([x[0] for x in inert])),
        com=f32(np.stack([x[1] for x in inert])),
        inertia=f32(np.stack([x[2] for x in inert])),
        ee_offset=f32(np.stack(ee_off)),
        joint_lower=f32(np.array(lower)),
        joint_upper=f32(np.array(upper)),
        effort_limit=f32(np.full(nj, EFFORT)),
        velocity_limit=f32(np.full(nj, VEL_LIM)),
    )


def stand_config() -> np.ndarray:
    """Nominal standing configuration [p(3), quat_xyzw(4), joints(12)]."""
    q = [0.0, 0.0, STAND_HEIGHT, 0.0, 0.0, 0.0, 1.0]
    for leg in LEGS:
        q.extend(STAND_JOINTS[leg])
    return np.array(q, dtype=np.float32)
