"""The port's MuJoCo bridge (``bilevel_gait_gen_tpu_torch/sim/
mujoco_bridge.py``) against the JAX package's, in MuJoCo.

* ``robot_to_mjcf``: the JAX package's string byte for byte for A1, Adam
  and the Mini Cheetah, from the port's float32 models and from copies of
  them in float64 (the numbers are formatted from float32 values, as the
  JAX models hold them);
* ``MujocoLoop``: both packages' loops from the same state under the same
  seeded torques for 50 steps give equal states, contacts and contact
  forces; the state round trip (quaternion xyzw <-> wxyz);
* ``_draw_overlay`` as tests/test_viz.py:47-65 draws the JAX package's;
* ``sim/closed_loop`` imports without ``mujoco``.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1
from bilevel_gait_gen_tpu.models import adam as jadam
from bilevel_gait_gen_tpu.models import mini_cheetah as jmc
from bilevel_gait_gen_tpu.sim import mujoco_bridge as jb
from bilevel_gait_gen_tpu_torch.models import a1, adam, mini_cheetah
from bilevel_gait_gen_tpu_torch.sim import mujoco_bridge as pb

FAMILIES = {
    "a1": (ja1.make_a1, a1.make_a1, a1.stand_config),
    "adam": (jadam.make_adam, adam.make_adam, adam.stand_config),
    "mini_cheetah": (jmc.make_mini_cheetah, mini_cheetah.make_mini_cheetah,
                     mini_cheetah.stand_config),
}


def _float64(model):
    return dataclasses.replace(model, **{
        f.name: getattr(model, f.name).double()
        for f in dataclasses.fields(model)
        if isinstance(getattr(model, f.name), torch.Tensor)
        and f.name != "total_mass"})


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_robot_to_mjcf_is_the_jax_string_byte_for_byte(family):
    make_jax, make_port, _ = FAMILIES[family]
    want = jb.robot_to_mjcf(make_jax())
    model = make_port(device="cpu")
    assert pb.robot_to_mjcf(model) == want
    wide = _float64(model)
    assert wide.mass.dtype == torch.float64
    assert pb.robot_to_mjcf(wide) == want
    assert (pb.robot_to_mjcf(model, foot_radius=0.03, timestep=0.002)
            == jb.robot_to_mjcf(make_jax(), foot_radius=0.03,
                                timestep=0.002))


def test_mujoco_loops_step_alike():
    ours = pb.MujocoLoop(a1.make_a1(device="cpu"))
    theirs = jb.MujocoLoop(ja1.make_a1())
    q0 = np.asarray(a1.stand_config(), np.float64)
    q0[2] -= 0.02
    v0 = np.zeros(18)
    v0[0] = 0.2
    for loop in (ours, theirs):
        loop.set_state(q0, v0)
    q, v = ours.get_state()
    np.testing.assert_allclose(q, q0.astype(np.float32), rtol=0, atol=1e-7)
    assert ours.mj_data.qpos[3] == q0[6]            # w first in MuJoCo
    rng = np.random.default_rng(4)
    taus = rng.normal(scale=5.0, size=(50, 12))
    seen, f_max = 0, 0.0
    for tau in taus:
        for loop in (ours, theirs):
            loop.mj_data.ctrl[:] = tau
            loop._mujoco.mj_step(loop.mj_model, loop.mj_data)
        for a, b in zip(ours.get_state(), theirs.get_state()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.contacts(), theirs.contacts())
        np.testing.assert_array_equal(ours.contact_forces(),
                                      theirs.contact_forces())
        seen += int(ours.contacts().sum())
        f_max = max(f_max, float(np.abs(ours.contact_forces()).max()))
    assert seen > 0 and f_max > 1.0
    out = ours.run(lambda q, v, t: np.full(12, 0.5), 5, control_decimation=2)
    ref = theirs.run(lambda q, v, t: np.full(12, 0.5), 5,
                     control_decimation=2)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_viewer_user_scene_overlay():
    import mujoco
    loop = pb.MujocoLoop(a1.make_a1(device="cpu"))
    loop.overlay = {
        "com_traj": np.linspace([0, 0, 0.3], [0.5, 0, 0.3], 21),
        "footholds": np.array([[0.2, 0.15], [0.2, -0.15]]),
        "ee_box": (np.array([[0.25, 0.15], [0.25, -0.15]]), (0.15, 0.15)),
    }
    scn = mujoco.MjvScene(loop.mj_model, maxgeom=200)
    loop._draw_overlay(scn)
    # 21 COM spheres + 2 footholds + 2 boxes
    assert scn.ngeom == 25
    assert scn.geoms[0].type == mujoco.mjtGeom.mjGEOM_SPHERE
    assert scn.geoms[scn.ngeom - 1].type == mujoco.mjtGeom.mjGEOM_BOX


def test_closed_loop_imports_without_mujoco():
    code = ("import sys; sys.modules['mujoco'] = None; "
            "import bilevel_gait_gen_tpu_torch.sim.closed_loop as c; "
            "assert 'jax' not in sys.modules; print(c.MujocoLoop.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "MujocoLoop"
