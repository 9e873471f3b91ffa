"""Host-side URDF parser -> the port's ``RobotModel`` (port of
``bilevel_gait_gen_tpu/models/urdf.py``).

Replaces the reference's Pinocchio URDF loading (mpc/models/model.cpp:14-37).
The parse runs once at model-build time on the host, with numpy and
``xml.etree`` (nothing URDF-shaped belongs on the device); only the finished
model's tensors go to the device asked for.  Fixed joints are folded into
their parent link: their child link's inertia is transported into the parent
frame and merged, and any end-effector frames attached beyond fixed joints
become (link, offset) pairs.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel


def _vec(s: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.array(default, dtype=np.float64)
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _origin(el) -> tuple[np.ndarray, np.ndarray]:
    """(xyz, rotation) of an element's ``origin`` child (identity if none)."""
    o = el.find("origin")
    xyz = _vec(o.get("xyz") if o is not None else None)
    return xyz, _rpy_matrix(_vec(o.get("rpy") if o is not None else None))


def _parse_inertial(link_el) -> tuple[float, np.ndarray, np.ndarray]:
    inertial = link_el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    com, R = _origin(inertial)
    it = inertial.find("inertia")
    I = np.array([
        [float(it.get("ixx")), float(it.get("ixy")), float(it.get("ixz"))],
        [float(it.get("ixy")), float(it.get("iyy")), float(it.get("iyz"))],
        [float(it.get("ixz")), float(it.get("iyz")), float(it.get("izz"))],
    ])
    return mass, com, R @ I @ R.T


def _merge_inertia(m1, c1, I1, m2, c2, I2):
    """Merge two bodies expressed in the same frame (inertias about their
    own COMs)."""
    m = m1 + m2
    if m == 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    c = (m1 * c1 + m2 * c2) / m

    def shift(mi, ci, Ii):
        d = ci - c
        return Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(m1, c1, I1) + shift(m2, c2, I2)


def load_urdf(path_or_string: str, root_link: str | None = None,
              ee_frames: Sequence[str] = (),
              hip_joints: Sequence[str] = (), *, device=None) -> RobotModel:
    """Parse a URDF (a path, or the XML itself) into a RobotModel whose
    tensors are float32 on ``device`` (default: the GPU).

    ee_frames: names of (possibly fixed-joint) links to expose as end
    effectors; hip_joints: revolute joint names whose frames anchor the
    EE-box constraints (reference GetCOMToHip).
    """
    device = resolve_device(device)
    if path_or_string.strip().startswith("<"):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()

    links = {l.get("name"): l for l in root.findall("link")}
    joints = list(root.findall("joint"))
    parent_of = {j.find("child").get("link"): j.find("parent").get("link")
                 for j in joints}

    # the root link: the first without a parent joint
    if root_link is None:
        candidates = [n for n in links if n not in parent_of]
        if not candidates:
            raise ValueError("no root link found")
        root_link = candidates[0]

    # Walk from the root, collapsing fixed joints.  canonical[link] =
    # (movable link, R offset, p offset) of the movable frame this link is
    # rigidly attached to.
    canonical: Dict[str, tuple[str, np.ndarray, np.ndarray]] = {
        root_link: (root_link, np.eye(3), np.zeros(3))}
    movable_links: List[str] = [root_link]
    movable_parent: Dict[str, str] = {}
    movable_joint: Dict[str, ET.Element] = {}

    # joints in dependency order: a joint is taken once its parent is known
    pending = joints[:]
    while pending:
        rest = []
        for j in pending:
            par = j.find("parent").get("link")
            child = j.find("child").get("link")
            if par not in canonical:
                rest.append(j)
                continue
            base, Rb, pb = canonical[par]
            xyz, R_origin = _origin(j)
            if j.get("type") == "fixed":
                canonical[child] = (base, Rb @ R_origin, pb + Rb @ xyz)
            else:
                movable_links.append(child)
                movable_parent[child] = base
                movable_joint[child] = j
                canonical[child] = (child, np.eye(3), np.zeros(3))
        if len(rest) == len(pending):
            break
        pending = rest

    # the inertias of all links, accumulated into their movable link
    agg = {n: (0.0, np.zeros(3), np.zeros((3, 3))) for n in movable_links}
    for name, el in links.items():
        if name not in canonical:
            continue
        base, R, p = canonical[name]
        m, c, I = _parse_inertial(el)
        agg[base] = _merge_inertia(*agg[base], m, p + R @ c, R @ I @ R.T)

    index = {n: i for i, n in enumerate(movable_links)}
    L = len(movable_links)
    parent_idx = [0] * L
    jtrans = np.zeros((L, 3))
    jaxis = np.zeros((L, 3))
    jaxis[:, 0] = 1.0
    lower, upper, effort, vel = [], [], [], []
    for name in movable_links[1:]:
        i = index[name]
        j = movable_joint[name]
        parent_idx[i] = index[movable_parent[name]]
        # joint origin relative to the canonical parent frame; only
        # translations are supported on movable joints (the A1, Adam and
        # Mini Cheetah URDFs use rpy="0 0 0" there)
        _, Rg, pg = canonical[j.find("parent").get("link")]
        xyz, R_origin = _origin(j)
        if not np.allclose(Rg @ R_origin, np.eye(3), atol=1e-6):
            raise ValueError(f"rotated joint origins are not supported "
                             f"(joint {j.get('name')})")
        jtrans[i] = pg + Rg @ xyz
        a = j.find("axis")
        jaxis[i] = _vec(a.get("xyz") if a is not None else (1, 0, 0))
        lim = j.find("limit")
        for out, key, default in ((lower, "lower", "-1e9"),
                                  (upper, "upper", "1e9"),
                                  (effort, "effort", "1e9"),
                                  (vel, "velocity", "1e9")):
            out.append(float(lim.get(key, default) if lim is not None
                             else default))

    ee_link, ee_off = [], []
    for f in ee_frames:
        base, _, p = canonical[f]
        ee_link.append(index[base])
        ee_off.append(p)

    jname_to_child = {j.get("name"): j.find("child").get("link")
                      for j in joints}
    hip_link = [index[canonical[jname_to_child[hj]][0]] for hj in hip_joints]

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return RobotModel(
        parent=tuple(parent_idx),
        ee_link=tuple(ee_link),
        hip_link=tuple(hip_link),
        ee_names=tuple(ee_frames),
        joint_names=tuple(movable_joint[n].get("name")
                          for n in movable_links[1:]),
        joint_trans=f32(jtrans),
        joint_axis=f32(jaxis),
        mass=f32([agg[n][0] for n in movable_links]),
        com=f32(np.stack([agg[n][1] for n in movable_links])),
        inertia=f32(np.stack([agg[n][2] for n in movable_links])),
        ee_offset=f32(np.stack(ee_off) if ee_off else np.zeros((0, 3))),
        joint_lower=f32(lower),
        joint_upper=f32(upper),
        effort_limit=f32(effort),
        velocity_limit=f32(vel),
    )
