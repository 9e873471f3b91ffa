"""Adam biped humanoid model for the PyTorch port (port of
``bilevel_gait_gen_tpu/models/adam.py``, whose make_adam returns the JAX
``RobotModel`` and so cannot be shared).

Biped family of the reference (models/adam/adam.urdf): per leg hip yaw/roll/
pitch + knee pitch (feet as point EEs like the reference's adam_sim_feet
config), per arm shoulder yaw/pitch + forearm pitch.  Two end effectors,
left foot then right foot.
"""
from __future__ import annotations

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel

TORSO = dict(m=6.0, com=(0, 0, 0),
             I=((0.03294, 0, 0), (0, 0.026016, 0), (0, 0, 0.014564)))


def _leg(side):  # side +1 left, -1 right
    s = side
    return [
        # (name suffix, parent offset, axis, mass, com, inertia)
        ("hip_yaw", (0.0, s * 0.047, -0.13), (0, 0, 1), 0.80187,
         (-0.04376, s * 0.03756, -0.056),
         ((0.001127, -s * 0.000131, 0.000228),
          (-s * 0.000131, 0.000947, -s * 0.000149),
          (0.000228, -s * 0.000149, 0.000798))),
        ("hip_roll", (-0.0255, s * 0.04175, -0.056), (1, 0, 0), 0.79036,
         (0.04899, -s * 0.05101, -0.01656),
         ((0.00062, -s * 6.4e-05, -7.5e-05),
          (-s * 6.4e-05, 0.000973, s * 2.4e-05),
          (-7.5e-05, s * 2.4e-05, 0.000726))),
        ("hip_pitch", (0.06, -s * 0.0275, -0.02325), (0, 1, 0), 1.201702,
         (0.003462, s * 0.043697, -0.041604),
         ((0.008223, -s * 9.5e-05, -0.000226),
          (-s * 9.5e-05, 0.008083, s * 0.001134),
          (-0.000226, s * 0.001134, 0.001422))),
        ("knee_pitch", (0.0, s * 0.021, -0.25), (0, 1, 0), 0.198026,
         (0.00069, 0.0, -0.10031),
         ((0.001694, 0, 1.6e-05), (0, 0.001701, 0),
          (1.6e-05, 0, 3.9e-05))),
    ]


def _arm(side):
    s = side
    return [
        ("shoulder_yaw", (0.0, s * 0.047, 0.13), (0, 0, 1), 0.83551,
         (0.0, s * 0.00048, 0.06448),
         ((0.0009, 0, -2.844e-08), (0, 0.001202, s * 4e-06),
          (-2.844e-08, s * 4e-06, 0.000543))),
        ("shoulder_pitch", (0.0, s * 0.0263, 0.075), (0, 1, 0), 0.348,
         (0.0, s * 0.04587, -0.06272),
         ((0.001911085, 0, 0), (0, 0.00190218, -s * 0.000156144),
          (0, -s * 0.000156144, 0.000189418))),
        ("forearm_pitch", (0.0, s * 0.058, -0.17), (0, 1, 0), 0.13,
         (0.0, 0.0, -0.08948),
         ((0.000667978, 0, 0), (0, 0.000672725, 0),
          (0, 0, 1.5241e-05))),
    ]


FOOT_OFFSET = (0.0, 0.0, -0.25)   # knee -> foot (fixed joint folded)
STAND_HEIGHT = 0.62


def make_adam(device=None) -> RobotModel:
    """The Adam model; its tensors are float32 on ``device`` (default: the
    GPU)."""
    device = resolve_device(device)
    names = ["torso"]
    parent = [0]
    jtrans = [np.zeros(3)]
    jaxis = [np.array([1.0, 0, 0])]
    inert = [(TORSO["m"], np.array(TORSO["com"]), np.array(TORSO["I"]))]
    joint_names = []
    ee_link, ee_off, hip_link = [], [], []

    def chain(side_name, links, first_is_hip):
        chain_parent = 0
        for k, (suffix, off, axis, m, com, I) in enumerate(links):
            i = len(names)
            names.append(f"{side_name}_{suffix}")
            parent.append(chain_parent)
            jtrans.append(np.array(off))
            jaxis.append(np.array(axis, dtype=float))
            inert.append((m, np.array(com), np.array(I)))
            joint_names.append(f"{side_name}_{suffix}_joint")
            if first_is_hip and k == 0:
                hip_link.append(i)
            chain_parent = i
        return chain_parent

    for side_name, s in (("left", 1.0), ("right", -1.0)):
        ee_link.append(chain(side_name, _leg(s), True))  # shin; foot folded
        ee_off.append(np.array(FOOT_OFFSET))
    for side_name, s in (("left", 1.0), ("right", -1.0)):
        chain(side_name, _arm(s), False)

    nj = len(names) - 1

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return RobotModel(
        parent=tuple(parent),
        ee_link=tuple(ee_link),
        hip_link=tuple(hip_link),
        ee_names=("left_foot", "right_foot"),
        joint_names=tuple(joint_names),
        joint_trans=f32(np.stack(jtrans)),
        joint_axis=f32(np.stack(jaxis)),
        mass=f32([x[0] for x in inert]),
        com=f32(np.stack([x[1] for x in inert])),
        inertia=f32(np.stack([x[2] for x in inert])),
        ee_offset=f32(np.stack(ee_off)),
        joint_lower=f32(np.full(nj, -2.5)),
        joint_upper=f32(np.full(nj, 2.5)),
        effort_limit=f32(np.full(nj, 60.0)),
        velocity_limit=f32(np.full(nj, 20.0)),
    )


def stand_config() -> np.ndarray:
    """Standing: slight knee bend, arms hanging
    [p(3), quat_xyzw(4), joints(14)]."""
    model = make_adam(device="cpu")
    q = np.zeros(7 + model.num_joints, dtype=np.float32)
    q[2] = STAND_HEIGHT
    q[6] = 1.0
    jn = list(model.joint_names)
    for side in ("left", "right"):
        q[7 + jn.index(f"{side}_hip_pitch_joint")] = -0.3
        q[7 + jn.index(f"{side}_knee_pitch_joint")] = 0.6
    return q
