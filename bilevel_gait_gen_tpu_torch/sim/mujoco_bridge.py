"""Host-MuJoCo closed loop (port of
``bilevel_gait_gen_tpu/sim/mujoco_bridge.py``; the rationale of the contact
parameters and of the conversions is documented there).

MuJoCo steps physics on the host in float64 while the controller runs on
the device.  :func:`robot_to_mjcf` writes the MJCF of a port
:class:`~bilevel_gait_gen_tpu_torch.models.rbd.RobotModel` as the JAX
package writes it, byte for byte: the JAX models hold float32 numpy
arrays, so every number is formatted from the model's values cast to
``np.float32``, whatever dtype and device the port's model has.
:class:`MujocoLoop` imports ``mujoco`` when it is made, never when this
module is imported.
"""
from __future__ import annotations

import numpy as np

from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel


def _f32(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def robot_to_mjcf(model: RobotModel, foot_radius: float = 0.02,
                  timestep: float = 0.001) -> str:
    """Generate a MuJoCo MJCF string from the kinematic tree."""
    L = model.num_links
    children = {i: [] for i in range(L)}
    for i in range(1, L):
        children[model.parent[i]].append(i)
    trans, axis = _f32(model.joint_trans), _f32(model.joint_axis)
    lower, upper = _f32(model.joint_lower), _f32(model.joint_upper)
    mass, com, inertia = _f32(model.mass), _f32(model.com), _f32(model.inertia)
    ee_offset, effort = _f32(model.ee_offset), _f32(model.effort_limit)

    def body_xml(i, indent):
        pad = "  " * indent
        t = trans[i]
        out = [f'{pad}<body name="link{i}" pos="{t[0]} {t[1]} {t[2]}">']
        if i == 0:
            out.append(f'{pad}  <freejoint name="root"/>')
        else:
            a = axis[i]
            jn = model.joint_names[i - 1]
            lo, hi = lower[i - 1], upper[i - 1]
            out.append(
                f'{pad}  <joint name="{jn}" type="hinge" '
                f'axis="{a[0]} {a[1]} {a[2]}" range="{lo} {hi}" damping="0.01"/>')
        m = mass[i]
        c = com[i]
        I = np.asarray(inertia[i], dtype=np.float64)
        # regularize tiny principal moments so MuJoCo accepts the body
        w, V = np.linalg.eigh(I)
        I = V @ np.diag(np.maximum(w, 1e-7)) @ V.T
        out.append(
            f'{pad}  <inertial pos="{c[0]} {c[1]} {c[2]}" mass="{m}" '
            f'fullinertia="{I[0,0]} {I[1,1]} {I[2,2]} '
            f'{I[0,1]} {I[0,2]} {I[1,2]}"/>')
        for e, li in enumerate(model.ee_link):
            if li == i:
                o = ee_offset[e]
                out.append(
                    f'{pad}  <geom name="{model.ee_names[e]}" type="sphere" '
                    f'size="{foot_radius}" pos="{o[0]} {o[1]} {o[2]}" '
                    f'condim="6" friction="0.6 0.02 0.01" '
                    f'solimp="0.9 0.99 0.001" solref="0.005 1"/>')
        for ch in children[i]:
            out.append(body_xml(ch, indent + 1))
        out.append(f"{pad}</body>")
        return "\n".join(out)

    actuators = "\n".join(
        f'    <motor name="m_{jn}" joint="{jn}" gear="1" '
        f'ctrlrange="-{effort[k]} {effort[k]}"/>'
        for k, jn in enumerate(model.joint_names))
    return f"""
<mujoco model="bgg_tpu_robot">
  <compiler angle="radian"/>
  <option timestep="{timestep}" integrator="implicitfast"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1" condim="6" friction="0.6 0.02 0.01"/>
{body_xml(0, 2)}
  </worldbody>
  <actuator>
{actuators}
  </actuator>
</mujoco>
"""


class MujocoLoop:
    """The closed loop: host MuJoCo physics + device controller.

    control_fn(q, v, t) -> torques [nj]; q and v are numpy in the port's
    conventions (quat xyzw, base angular velocity in the body frame).
    ``overlay`` holds the live plan that :meth:`run` draws into the
    viewer's user scene (keys ``com_traj`` [N, 3], ``footholds``
    [E, 2 or 3], ``ee_box`` (centers [E, 2], (sx, sy)))."""

    def __init__(self, model: RobotModel, foot_radius: float = 0.02,
                 timestep: float = 0.001):
        import mujoco
        self._mujoco = mujoco
        self.model = model
        self.mj_model = mujoco.MjModel.from_xml_string(
            robot_to_mjcf(model, foot_radius, timestep))
        self.mj_data = mujoco.MjData(self.mj_model)
        self.timestep = timestep
        self.overlay: dict | None = None

    # MuJoCo's free joint takes the quaternion wxyz and the base's linear
    # velocity in the world frame, its angular velocity in the body frame
    def set_state(self, q: np.ndarray, v: np.ndarray):
        q = np.asarray(q, np.float64)
        v = np.asarray(v, np.float64)
        self.mj_data.qpos[:3] = q[0:3]
        self.mj_data.qpos[3:7] = [q[6], q[3], q[4], q[5]]  # xyzw -> wxyz
        self.mj_data.qpos[7:] = q[7:]
        self.mj_data.qvel[:3] = v[0:3]
        self.mj_data.qvel[3:6] = v[3:6]
        self.mj_data.qvel[6:] = v[6:]
        self._mujoco.mj_forward(self.mj_model, self.mj_data)

    def get_state(self):
        """(q [nq], v [nv]) as float32 numpy, quaternion xyzw."""
        d = self.mj_data
        q = np.concatenate([d.qpos[:3],
                            [d.qpos[4], d.qpos[5], d.qpos[6], d.qpos[3]],
                            d.qpos[7:]])
        v = np.concatenate([d.qvel[:3], d.qvel[3:6], d.qvel[6:]])
        return q.astype(np.float32), v.astype(np.float32)

    def _foot_geoms(self, i):
        m, c = self.mj_model, self.mj_data.contact[i]
        name = self._mujoco.mj_id2name
        kind = self._mujoco.mjtObj.mjOBJ_GEOM
        return name(m, kind, c.geom1), name(m, kind, c.geom2)

    def contacts(self) -> np.ndarray:
        """[E] bool: foot geoms currently in contact with the floor."""
        flags = np.zeros(self.model.num_ee, bool)
        name_to_e = {n: e for e, n in enumerate(self.model.ee_names)}
        for i in range(self.mj_data.ncon):
            for g in self._foot_geoms(i):
                if g in name_to_e:
                    flags[name_to_e[g]] = True
        return flags

    def contact_forces(self) -> np.ndarray:
        """[E, 3] world-frame ground-reaction force on each foot: the sum
        of ``mj_contactForce`` over that foot's contacts, rotated out of
        the contact frame."""
        d = self.mj_data
        out = np.zeros((self.model.num_ee, 3))
        name_to_e = {n: e for e, n in enumerate(self.model.ee_names)}
        f6 = np.zeros(6)
        for i in range(d.ncon):
            g1, g2 = self._foot_geoms(i)
            e = name_to_e.get(g1, name_to_e.get(g2))
            if e is None:
                continue
            self._mujoco.mj_contactForce(self.mj_model, d, i, f6)
            frame = d.contact[i].frame.reshape(3, 3)
            fw = frame.T @ f6[:3]            # contact frame -> world
            # mj_contactForce reports the force ON geom1: flip it when the
            # foot is geom1 (the force wanted is the floor's on the foot)
            out[e] += fw if g2 in name_to_e else -fw if g1 in name_to_e \
                else fw
        return out

    def _draw_overlay(self, scn):
        """Draw the stored MPC plan into a viewer user scene: the planned
        COM trajectory, the footholds and the EE boxes as debug geoms."""
        mujoco = self._mujoco
        ov = self.overlay
        eye = np.eye(3, dtype=np.float64).reshape(-1)
        scn.ngeom = 0

        def add(gtype, size, pos, rgba):
            if scn.ngeom >= scn.maxgeom:
                return
            g = scn.geoms[scn.ngeom]
            mujoco.mjv_initGeom(g, gtype, np.asarray(size, np.float64),
                                np.asarray(pos, np.float64), eye,
                                np.asarray(rgba, np.float32))
            scn.ngeom += 1

        for p in np.asarray(ov.get("com_traj", np.zeros((0, 3)))):
            add(mujoco.mjtGeom.mjGEOM_SPHERE, [0.008, 0, 0], p,
                [0.2, 0.5, 1.0, 0.8])
        for p in np.asarray(ov.get("footholds", np.zeros((0, 2)))):
            pos = [p[0], p[1], p[2] if len(p) > 2 else 0.005]
            add(mujoco.mjtGeom.mjGEOM_SPHERE, [0.015, 0, 0], pos,
                [0.1, 0.9, 0.2, 0.9])
        if "ee_box" in ov:
            centers, (sx, sy) = ov["ee_box"]
            for c in np.asarray(centers):
                add(mujoco.mjtGeom.mjGEOM_BOX, [sx / 2, sy / 2, 0.002],
                    [c[0], c[1], 0.004], [1.0, 0.8, 0.1, 0.35])

    def run(self, control_fn, n_steps: int, control_decimation: int = 1,
            viewer: bool = False, realtime: bool = False):
        """Step physics, calling control_fn every ``control_decimation``
        steps; returns the logged (qs, vs, taus) in MuJoCo's layout.

        ``viewer`` opens MuJoCo's passive viewer for the run (it needs a
        display; without one the run goes on headless with a warning);
        ``realtime`` paces the steps to the wall clock."""
        handle = None
        if viewer:
            try:
                import mujoco.viewer as _mjviewer
                handle = _mjviewer.launch_passive(self.mj_model,
                                                  self.mj_data)
            except Exception as exc:  # headless / no GL
                print(f"[mujoco_bridge] viewer unavailable ({exc}); "
                      "running headless")
        import time as _time
        t_wall0 = _time.perf_counter()
        qs, vs, taus = [], [], []
        tau = np.zeros(self.model.num_joints, np.float64)
        try:
            for k in range(n_steps):
                if handle is not None and not handle.is_running():
                    break
                if k % control_decimation == 0:
                    q, v = self.get_state()
                    tau = np.asarray(control_fn(q, v, k * self.timestep),
                                     np.float64)
                self.mj_data.ctrl[:] = tau
                self._mujoco.mj_step(self.mj_model, self.mj_data)
                qs.append(self.mj_data.qpos.copy())
                vs.append(self.mj_data.qvel.copy())
                taus.append(tau.copy())
                if handle is not None:
                    if self.overlay is not None and k % 20 == 0:
                        self._draw_overlay(handle.user_scn)
                    handle.sync()
                if realtime:
                    lag = (k + 1) * self.timestep - (_time.perf_counter()
                                                     - t_wall0)
                    if lag > 0:
                        _time.sleep(lag)
        finally:
            if handle is not None:
                handle.close()
        return np.array(qs), np.array(vs), np.array(taus)
