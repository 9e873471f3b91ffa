"""Port parity, float64, of the other robot families (the Adam biped, the
Mini Cheetah), the URDF loader and the shipped YAML configurations against
the JAX package.

Tolerances: the models are the same float32 numbers bit for bit; their
kinematics agree to rtol 1e-10 (atol 1e-12), as in
tests/test_torch_models.py (the same formulas in float64 on the same
float32-rounded parameters, sums in another order); the cold start's cost
to 1e-8 relative and its defect to atol 1e-10 (float64 interior-point
solves converged to ~1e-9 gaps whose last digits differ), its solved flags
equal."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import adam as jadam
from bilevel_gait_gen_tpu.models import mini_cheetah as jmc
from bilevel_gait_gen_tpu.models import rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.models import urdf as jurdf
from bilevel_gait_gen_tpu.mpc import gait as jgait, solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu.utils import config as jconfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.models import adam, mini_cheetah, rbd, urdf
from bilevel_gait_gen_tpu_torch.mpc import solver
from bilevel_gait_gen_tpu_torch.problem import perturbations
from bilevel_gait_gen_tpu_torch.utils import config

import chip_smoke
from torch_jax_common import jit

torch.set_num_threads(2)

RTOL, ATOL = 1e-10, 1e-12
F64 = torch.float64
ROOT = Path(__file__).resolve().parent.parent
FAMILIES = {"adam": (adam.make_adam, adam.stand_config, jadam),
            "mini_cheetah": (mini_cheetah.make_mini_cheetah,
                             mini_cheetah.stand_config, jmc)}
TENSORS = ("joint_trans", "joint_axis", "mass", "com", "inertia", "ee_offset",
           "joint_lower", "joint_upper", "effort_limit", "velocity_limit",
           "total_mass")
STATIC = ("parent", "ee_link", "hip_link", "ee_names", "joint_names")


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def jax_model(family):
    mod = FAMILIES[family][2]
    return mod.make_adam() if family == "adam" else mod.make_mini_cheetah()


def assert_same_model(model, ref):
    """Every field of two port models the same (tensors bit for bit)."""
    for name in STATIC:
        assert getattr(model, name) == getattr(ref, name), name
    for name in TENSORS:
        got, want = getattr(model, name), getattr(ref, name)
        assert got.dtype == want.dtype == torch.float32, name
        assert got.device == want.device, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("family", FAMILIES)
def test_make_family_matches_jax_model(family):
    """The port's model is the JAX model carried across by
    ``convert.from_robot_model``, field by field and bit for bit; the stand
    configuration is the same array."""
    make, stand, jmod = FAMILIES[family]
    assert_same_model(make(device="cpu"),
                      convert.from_robot_model(jax_model(family),
                                               device="cpu"))
    np.testing.assert_array_equal(stand(), jmod.stand_config())
    assert stand().dtype == np.float32
    port_mod = adam if family == "adam" else mini_cheetah
    assert port_mod.STAND_HEIGHT == jmod.STAND_HEIGHT


def _configs(family, k=4):
    rng = np.random.default_rng(21)
    q0 = FAMILIES[family][1]().astype(np.float64)
    q = np.tile(q0, (k, 1))
    q += 0.1 * rng.standard_normal(q.shape)
    q[0] = q0
    return q


@pytest.mark.parametrize("family", FAMILIES)
def test_family_kinematics_match_jax(family):
    """FK of every link, the feet, the hips, the COM and the composite
    inertia about it at the stand and at three configurations moved by
    0.1 N(0, 1) (quaternion renormalized by both sides)."""
    q = _configs(family)
    jm = jax_model(family)
    model = FAMILIES[family][0](device="cpu")
    qt = torch.tensor(q, dtype=F64)
    Rj, pj = jax.vmap(lambda qq: jrbd.fk_links(jm, qq))(jnp.asarray(q))
    R, p = rbd.fk_links(model, qt)
    close(R, Rj)
    close(p, pj)
    for fn in ("ee_positions", "hip_positions", "com_position",
               "composite_inertia_about_com"):
        ref = jax.vmap(lambda qq: getattr(jrbd, fn)(jm, qq))(jnp.asarray(q))
        close(getattr(rbd, fn)(model, qt), ref)


# ---------------------------------------------------------------------------
# the cold start of tests/test_models_multi.py::test_mpc_solves_for_family
# ---------------------------------------------------------------------------

def _jax_start(family, cfg, batch):
    """The JAX side of chip_smoke.family_problem: (params, states, x0s,
    feet, x_des), the state stacked over the batch."""
    jm = jax_model(family)
    q0 = jnp.asarray(FAMILIES[family][2].stand_config(), jnp.float64)
    params = jsrb.make_srb_params(jm, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(jm.nv, jnp.float64))
    feet = jrbd.ee_positions(jm, q0)
    traj = default_trajectory(cfg, jgait.make_trot(cfg), x0, feet[:, :2])
    state = jsolver.make_state(cfg, traj,
                               jnp.asarray(cfg.ee_box_size, jnp.float64))
    states = jax.tree.map(lambda a: jnp.stack([a] * batch), state)
    x0s = x0[None] + jnp.asarray(perturbations(batch, seed=0))
    return params, states, x0s, feet, jsrb.manifold_to_tangent(x0)


@pytest.mark.parametrize("family", FAMILIES)
def test_create_initial_run_matches_jax(family):
    """``solver.create_initial_run`` at num_nodes=10, force_bound=500,
    ipm_iters=20 (the JAX package's family test), batch 2 with the
    perturbed states of chip_smoke.py phase 11: cost within 1e-8 relative,
    defect_l1 within 1e-10, the same solved flags, the planned trajectory
    within 1e-6."""
    jcfg = jconfig.MPCConfig(num_nodes=10,
                             num_ee=2 if family == "adam" else 4,
                             ipm_iters=20, force_bound=500.0).validate()
    cfg = convert.from_config(jcfg)
    params, states, x0s, feet, x_des = _jax_start(family, jcfg, 2)
    jst, jstats = jit(jax.vmap(lambda st, x: jsolver.create_initial_run(
        jcfg, params, st, x, feet, x_des)))(states, x0s)
    pr = chip_smoke.family_problem(family, cfg, 2, "cpu", F64)
    # the same start (reconstruct_state sums in another order: ~1 ulp)
    np.testing.assert_allclose(pr.x0s.numpy(), np.asarray(x0s), rtol=0,
                               atol=1e-14)
    st, stats = solver.create_initial_run(cfg, pr.params, pr.states, pr.x0s,
                                          pr.feets, pr.x_des, pr.t0)
    assert bool(stats.solved.all())
    np.testing.assert_array_equal(stats.solved.numpy(),
                                  np.asarray(jstats.solved))
    np.testing.assert_allclose(stats.cost.numpy(), np.asarray(jstats.cost),
                               rtol=1e-8)
    np.testing.assert_allclose(stats.defect_l1.numpy(),
                               np.asarray(jstats.defect_l1), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(st.traj.x_man.numpy(),
                               np.asarray(jst.traj.x_man), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the URDF loader
# ---------------------------------------------------------------------------

def _inertial(m, xyz, rpy, ixx, iyy, izz, ixy=0.0, ixz=0.0, iyz=0.0):
    return (f'<inertial><origin xyz="{xyz}" rpy="{rpy}"/><mass value="{m}"/>'
            f'<inertia ixx="{ixx}" ixy="{ixy}" ixz="{ixz}" iyy="{iyy}" '
            f'iyz="{iyz}" izz="{izz}"/></inertial>')


def _joint(name, kind, parent, child, xyz, rpy="0 0 0", axis=None,
           limit=None):
    return (f'<joint name="{name}" type="{kind}"><parent link="{parent}"/>'
            f'<child link="{child}"/><origin xyz="{xyz}" rpy="{rpy}"/>'
            + (f'<axis xyz="{axis}"/>' if axis else "")
            + (f'<limit {limit}/>' if limit else "") + "</joint>")


def _urdf():
    """A two-legged robot with what the loader folds: an IMU and a battery
    on fixed joints with rpy origins (their inertias merged into the
    trunk, the battery's inertial itself rotated), off-origin inertials, a
    sensor link with no inertial, feet on fixed joints beyond the shins
    (the end effectors), a leg whose hip sits on a fixed mount with an rpy
    of a full turn, and one joint without limits."""
    links = [
        ("trunk", _inertial(5.0, "0.01 -0.002 0.003", "0 0 0", 0.05, 0.12,
                            0.14, 1e-3, -2e-3, 5e-4)),
        ("imu", _inertial(0.05, "0.0 0.0 0.01", "0 0 0", 1e-4, 1e-4, 1e-4)),
        ("battery", _inertial(1.2, "0.02 0.01 -0.01", "0.1 -0.2 0.3", 2e-3,
                              5e-3, 6e-3, 1e-4)),
        ("camera", None),
        ("mount_r", _inertial(0.1, "0 -0.01 0", "0 0 0", 1e-5, 1e-5, 1e-5)),
    ]
    joints = [
        _joint("imu_fix", "fixed", "trunk", "imu", "0.05 0 0.02",
               "0.3 0 -0.1"),
        _joint("battery_fix", "fixed", "trunk", "battery", "-0.05 0 -0.03",
               "0 0.2 0"),
        _joint("camera_fix", "fixed", "imu", "camera", "0.1 0 0"),
        _joint("mount_r_fix", "fixed", "trunk", "mount_r", "0 -0.08 0",
               f"0 0 {2 * np.pi}"),
    ]
    for side, parent, y in (("l", "trunk", 0.08), ("r", "mount_r", 0.0)):
        links += [
            (f"hip_{side}", _inertial(0.7, "0 0.01 -0.02", "0 0 0", 1e-3,
                                      2e-3, 1e-3, 1e-5)),
            (f"thigh_{side}", _inertial(1.0, "0 0 -0.1", "0.05 0 0", 5e-3,
                                        5e-3, 1e-3, 0.0, 3e-4)),
            (f"shin_{side}", _inertial(0.2, "0.005 0 -0.12", "0 0 0", 2e-3,
                                       2e-3, 5e-5)),
            (f"foot_{side}", _inertial(0.05, "0 0 0", "0 0 0", 1e-5, 1e-5,
                                       1e-5)),
        ]
        joints += [
            _joint(f"hip_{side}_j", "revolute", parent, f"hip_{side}",
                   f"0 {y} -0.05", axis="1 0 0",
                   limit='lower="-0.8" upper="0.8" effort="30" '
                         'velocity="20"'),
            _joint(f"thigh_{side}_j", "revolute", f"hip_{side}",
                   f"thigh_{side}", "0 0 -0.04", axis="0 1 0",
                   limit='lower="-1.5" upper="2.5" effort="30" '
                         'velocity="20"'),
            _joint(f"knee_{side}_j", "continuous", f"thigh_{side}",
                   f"shin_{side}", "0 0 -0.2", axis="0 -1 0"),
            _joint(f"foot_{side}_fix", "fixed", f"shin_{side}",
                   f"foot_{side}", "0.01 0 -0.21", "0 0.4 0"),
        ]
    body = "".join(f'<link name="{n}">{i or ""}</link>' for n, i in links)
    return f'<robot name="test">{body}{"".join(joints)}</robot>'


def test_load_urdf_matches_jax(tmp_path):
    """``load_urdf`` from the XML string and from a file, against the JAX
    package's parse of the same string: every field the same (the float32
    tensors bit for bit: both sides fold the same float64 numbers), then FK
    and the composite inertia at four configurations (rtol 1e-10)."""
    text = _urdf()
    kw = dict(ee_frames=("foot_l", "foot_r", "camera"),
              hip_joints=("hip_l_j", "hip_r_j"))
    jm = jurdf.load_urdf(text, **kw)
    model = urdf.load_urdf(text, device="cpu", **kw)
    assert model.num_joints == 6 and model.num_ee == 3
    assert_same_model(model, convert.from_robot_model(jm, device="cpu"))
    path = tmp_path / "robot.urdf"
    path.write_text(text)
    assert_same_model(urdf.load_urdf(str(path), device="cpu", **kw), model)
    # the trunk carries the IMU, the battery and the right leg's mount
    assert float(model.mass[0]) == np.float32(5.0 + 0.05 + 1.2 + 0.1)
    rng = np.random.default_rng(22)
    q = np.zeros((4, 7 + 6))
    q[:, 2] = 0.4
    q[:, 3:7] = rng.standard_normal((4, 4))
    q[:, 7:] = 0.3 * rng.standard_normal((4, 6))
    qt = torch.tensor(q, dtype=F64)
    for fn in ("fk_links", "ee_positions", "hip_positions",
               "composite_inertia_about_com"):
        ref = jax.vmap(lambda qq: getattr(jrbd, fn)(jm, qq))(jnp.asarray(q))
        got = getattr(rbd, fn)(model, qt)
        for g_, r_ in zip(*((got, ref) if fn == "fk_links"
                            else ((got,), (ref,)))):
            close(g_, r_)


def test_load_urdf_refuses_what_it_cannot_fold():
    """A rotated origin on a movable joint is refused, as in the JAX
    package (which asserts)."""
    text = _urdf().replace('<origin xyz="0 0 -0.04" rpy="0 0 0"/>',
                           '<origin xyz="0 0 -0.04" rpy="0.2 0 0"/>', 1)
    with pytest.raises(AssertionError):
        jurdf.load_urdf(text)
    with pytest.raises(ValueError, match="rotated joint origins"):
        urdf.load_urdf(text, device="cpu")


# ---------------------------------------------------------------------------
# the shipped configurations
# ---------------------------------------------------------------------------

YAMLS = sorted(p.name for p in (ROOT / "bilevel_gait_gen_tpu"
                                / "configs").glob("*.yaml"))


def test_the_port_ships_every_yaml():
    assert YAMLS == sorted(
        p.name for p in (ROOT / "bilevel_gait_gen_tpu_torch"
                         / "configs").glob("*.yaml"))
    assert len(YAMLS) == 6


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_copy_is_byte_for_byte_and_loads_the_same(name):
    """The port's copy is the JAX package's file byte for byte, and the
    port's ``load_yaml`` of it gives the JAX ``load_yaml``'s fields."""
    mine = ROOT / "bilevel_gait_gen_tpu_torch" / "configs" / name
    ref = ROOT / "bilevel_gait_gen_tpu" / "configs" / name
    assert mine.read_bytes() == ref.read_bytes()
    assert dataclasses.asdict(config.load_yaml(str(mine))) == \
        dataclasses.asdict(jconfig.load_yaml(str(ref)))


def test_chip_smoke_adam_config_is_the_shipped_yaml():
    """Phase 11 of chip_smoke.py runs Adam under the port's copy of
    adam_march.yaml as it stands, and the Mini Cheetah under bench.py's
    configuration."""
    jcfg = jconfig.load_yaml(str(ROOT / "bilevel_gait_gen_tpu" / "configs"
                                 / "adam_march.yaml"))
    cfg = chip_smoke.family_config("adam")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_nodes, cfg.num_ee, cfg.ipm_iters, cfg.ls_alphas,
            cfg.raibert, cfg.force_carrier) == (20, 2, 25, 4, True, True)
    assert chip_smoke.family_config("mini_cheetah") == \
        chip_smoke.bench_config()
