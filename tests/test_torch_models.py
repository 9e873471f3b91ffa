"""Port parity, float64: quaternions, rigid-body kinematics, the A1 model
and the single-rigid-body model against the JAX package.

Tolerance: rtol 1e-10 (atol 1e-12 near zero).  Both sides evaluate the same
formulas in float64 on the same float32-rounded model parameters; only the
order of a few sums differs, which costs ~1e-15 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu.ops import quat as jquat
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
from bilevel_gait_gen_tpu_torch.ops import quat

torch.set_num_threads(2)

RTOL, ATOL = 1e-10, 1e-12
F64 = torch.float64


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _quats(seed, k=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((k, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [0.0, 0.0, 0.0, 1.0]                     # identity
    q[1] = [1e-6, -2e-6, 5e-7, -1.0]                # near -identity
    return q


@pytest.mark.parametrize("fn", ["normalize", "to_matrix", "log3", "yaw",
                                "conjugate"])
def test_quat_unary(fn):
    q = _quats(0) * 1.7
    ref = jax.vmap(getattr(jquat, fn))(jnp.asarray(q))
    close(getattr(quat, fn)(t(q)), ref)


def test_quat_binary_and_exp():
    q1, q2 = _quats(1), _quats(2)
    v = np.random.default_rng(3).standard_normal((6, 3))
    v[0] = 0.0
    v[1] = 1e-6
    close(quat.multiply(t(q1), t(q2)),
          jax.vmap(jquat.multiply)(jnp.asarray(q1), jnp.asarray(q2)))
    close(quat.rotate(t(q1), t(v)),
          jax.vmap(jquat.rotate)(jnp.asarray(q1), jnp.asarray(v)))
    close(quat.exp3(t(v)), jax.vmap(jquat.exp3)(jnp.asarray(v)))
    close(quat.box_plus(t(q1), t(v)),
          jax.vmap(jquat.box_plus)(jnp.asarray(q1), jnp.asarray(v)))
    close(quat.box_minus(t(q1), t(q2)),
          jax.vmap(jquat.box_minus)(jnp.asarray(q1), jnp.asarray(q2)))
    close(quat.skew(t(v)), jax.vmap(jquat.skew)(jnp.asarray(v)))
    close(quat.from_euler_zyx(t(v)),
          jax.vmap(jquat.from_euler_zyx)(jnp.asarray(v)))


def test_quat_log_exp_gradients_match_at_identity_and_zero():
    """The series branches keep the derivative finite where theta = 0."""
    q = np.array([[0.0, 0.0, 0.0, 1.0], [0.1, -0.2, 0.3, 0.9]])
    gj = jax.vmap(jax.jacfwd(jquat.log3))(jnp.asarray(q))
    gt = torch.func.vmap(torch.func.jacfwd(quat.log3))(t(q))
    close(gt, gj)
    w = np.array([[0.0, 0.0, 0.0], [0.3, -0.1, 0.2]])
    gj = jax.vmap(jax.jacfwd(jquat.exp3))(jnp.asarray(w))
    gt = torch.func.vmap(torch.func.jacfwd(quat.exp3))(t(w))
    assert np.isfinite(convert.to_numpy(gt)).all()
    close(gt, gj)


def _configs(k=4):
    rng = np.random.default_rng(4)
    q = np.tile(ja1.stand_config().astype(np.float64), (k, 1))
    q += 0.1 * rng.standard_normal(q.shape)
    q[0] = ja1.stand_config()
    return q


def test_make_a1_matches_jax_model():
    model = a1.make_a1()
    jm = ja1.make_a1()
    assert model.parent == jm.parent and model.ee_link == jm.ee_link
    assert model.hip_link == jm.hip_link
    for name in ("joint_trans", "joint_axis", "mass", "com", "inertia",
                 "ee_offset", "joint_lower", "joint_upper", "effort_limit",
                 "velocity_limit"):
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    assert abs(float(model.total_mass) - 13.741) < 1e-4
    np.testing.assert_array_equal(a1.stand_config(), ja1.stand_config())


@pytest.mark.parametrize("fn", ["ee_positions", "hip_positions",
                                "com_position",
                                "composite_inertia_about_com"])
def test_rbd_kinematics(fn):
    q = _configs()
    ref = jax.vmap(lambda qq: getattr(jrbd, fn)(ja1.make_a1(), qq))(
        jnp.asarray(q))
    close(getattr(rbd, fn)(a1.make_a1(), t(q)), ref)


def test_rbd_fk_links():
    q = _configs()
    Rj, pj = jax.vmap(lambda qq: jrbd.fk_links(ja1.make_a1(), qq))(
        jnp.asarray(q))
    R, p = rbd.fk_links(a1.make_a1(), t(q))
    close(R, Rj)
    close(p, pj)


def test_a1_hip_offsets_and_inertia():
    q0 = t(a1.stand_config())
    params = srb.make_srb_params(a1.make_a1(), q0)
    off = params.hip_offset_raw.numpy()
    np.testing.assert_allclose(np.abs(off[:, 0]), [0.1805] * 4, atol=0.03)
    assert np.all(np.abs(params.hip_offset[:, 1].numpy()) > 0.14)
    np.testing.assert_allclose(np.diag(params.inertia.numpy()),
                               [0.150, 0.369, 0.390], atol=0.05)


def test_srb_params_and_state():
    q0 = ja1.stand_config().astype(np.float64)
    jp = jsrb.make_srb_params(ja1.make_a1(), jnp.asarray(q0))
    p = srb.make_srb_params(a1.make_a1(), t(q0))
    for name in ("mass", "inertia", "inertia_inv", "hip_offset",
                 "com_offset", "hip_offset_raw"):
        close(getattr(p, name), getattr(jp, name))
    q = _configs()
    v = np.random.default_rng(5).standard_normal((q.shape[0], 18))
    ref = jax.vmap(lambda qq, vv: jsrb.reconstruct_state(jp, qq, vv))(
        jnp.asarray(q), jnp.asarray(v))
    close(srb.reconstruct_state(p, t(q), t(v)), ref)
    xt = jax.vmap(jsrb.manifold_to_tangent)(ref)
    close(srb.manifold_to_tangent(t(ref)), xt)
    close(srb.tangent_to_manifold(t(xt)),
          jax.vmap(jsrb.tangent_to_manifold)(xt))


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_srb_dynamics_and_step(integrator):
    cfg = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                    samples_per_stance=4, ee_node_start=1, dt=0.05,
                    integrator=integrator).validate()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    jp = jsrb.make_srb_params(ja1.make_a1(), q0)
    x0 = jsrb.reconstruct_state(jp, q0, jnp.zeros(18))
    feet = jrbd.ee_positions(ja1.make_a1(), q0)
    traj = default_trajectory(cfg, jgait.make_trot(cfg), x0, feet[:, :2])
    rng = np.random.default_rng(6)
    fn = jnp.asarray(rng.standard_normal(traj.f_nodes.shape))
    fh = traj.footholds + 0.02 * rng.standard_normal(traj.footholds.shape)
    xt = jsrb.manifold_to_tangent(x0) + 0.05 * rng.standard_normal(12)
    times = np.array([0.0, 0.12, 0.25, 0.5, 0.77])
    bounds = traj.sched.bounds
    ref = jax.vmap(lambda tt: jsrb.discrete_step(
        jp, xt, fn, fh, bounds, tt, cfg.dt, cfg))(jnp.asarray(times))
    dyn = jax.vmap(lambda tt: jsrb.dynamics(jp, xt, fn, fh, bounds, tt, cfg))(
        jnp.asarray(times))
    p = convert.from_srb_params(jp)
    args = (t(np.tile(np.asarray(xt), (len(times), 1))), t(fn), t(fh),
            t(bounds), t(times))
    close(srb.dynamics(p, *args, cfg), dyn)
    close(srb.discrete_step(p, *args, cfg.dt, cfg), ref)
