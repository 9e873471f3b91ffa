"""Port parity, float64: inverse kinematics, the whole-body QP and the MPC
controller (``control/``) against the JAX package, B scenarios on the
port's side against ``jax.vmap`` of the reference.

Tolerances: the IK to 1e-9 rad (30 damped Gauss-Newton steps; the port
solves each 12x12 system by Cholesky where JAX uses LU, ~1e-15 apart per
step).  Torques to 1e-7 N m, measured ~4e-14: both sides run the same 15
float64 interior-point sweeps and differ only in the order of a few sums,
but the sweeps' last matrices are conditioned up to ~1e8 (the barrier
weights spread over ~8 decades), so other states may amplify that
difference by as much; the bound keeps six decades for it and sits five
decades under the ~1e-2 N m that an error of formulation (a missing row, a
sign) shows.  The controller's targets (interpolated state, IK, spline
velocities and forces) to 1e-9 of each quantity's largest magnitude."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.control import ik as jik, mpc_controller as jmc
from bilevel_gait_gen_tpu.control import wbqp as jwbqp
from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait, solver as jsolver
from bilevel_gait_gen_tpu.mpc.gait import GaitSchedule as JSched
from bilevel_gait_gen_tpu.mpc.trajectory import (Trajectory as JTraj,
                                                 default_trajectory as jdeft)
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.control import ik, mpc_controller, wbqp
from bilevel_gait_gen_tpu_torch.models import a1
from bilevel_gait_gen_tpu_torch.mpc import solver
from torch_jax_common import jit_per_scenario

torch.set_num_threads(2)

F64 = torch.float64
TAU_ATOL = 1e-7
CFG = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                samples_per_stance=4, ee_node_start=1, ipm_iters=15,
                init_run_iters=3, max_ls_iters=4, dt=0.05).validate()
# FL, FR, RL, RR in contact: all four; the trot's diagonal pair FR + RL
# (FL and RR in swing); a scheduled stance with the RL foot measured off
MASKS = np.array([[1, 1, 1, 1], [0, 1, 1, 0], [1, 1, 0, 1]], dtype=bool)


def t(a):
    return torch.tensor(np.asarray(a))


def assert_close_rel(port, ref, rtol):
    p, r = convert.to_numpy(port), np.asarray(ref)
    assert p.shape == r.shape
    np.testing.assert_allclose(p, r, rtol=0,
                               atol=rtol * max(np.abs(r).max(), 1e-300))


def _configs(k, seed):
    rng = np.random.default_rng(seed)
    q = np.tile(ja1.stand_config().astype(np.float64), (k, 1))
    q[:, 7:] += 0.08 * rng.standard_normal((k, 12))
    q[:, :3] += 0.01 * rng.standard_normal((k, 3))
    q[:, 3:7] += 0.03 * rng.standard_normal((k, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    return q


@pytest.fixture(scope="module")
def models():
    return ja1.make_a1(), a1.make_a1(device="cpu")


def test_solve_ik_matches_jax(models):
    """30 iterations, foot targets 2-3 cm from the configuration's feet."""
    jm, pm = models
    q = _configs(4, 0)
    rng = np.random.default_rng(1)
    step = rng.standard_normal((4, 4, 3))
    step *= rng.uniform(0.02, 0.03, (4, 4, 1)) / np.linalg.norm(
        step, axis=-1, keepdims=True)
    feet = np.asarray(jax.vmap(lambda qq: jrbd.ee_positions(jm, qq))(
        jnp.asarray(q))) + step
    guess = np.tile(ja1.stand_config().astype(np.float64), (4, 1))
    base_q = q[:, 3:7] * 1.3           # the result normalizes the quaternion
    ref = jit_per_scenario(lambda p, b, f, g: jik.solve_ik(
        jm, p, b, f, g, iters=30))(q[:, :3], base_q, feet, guess)
    got = ik.solve_ik(pm, t(q[:, :3]), t(base_q), t(feet), t(guess),
                      iters=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)
    # the targets are reached where the joint limits allow
    np.testing.assert_allclose(got[:, 3:7].norm(dim=-1).numpy(), 1.0)


def test_ik_velocities_match_jax(models):
    jm, pm = models
    q = _configs(4, 2)
    rng = np.random.default_rng(3)
    bv, bw = rng.standard_normal((4, 3)) * 0.3, rng.standard_normal((4, 3))
    fv = rng.standard_normal((4, 4, 3)) * 0.5
    ref = jit_per_scenario(lambda *a: jik.ik_velocities(jm, *a))(
        q, bv, bw, fv)
    got = ik.ik_velocities(pm, t(q), t(bv), t(bw), t(fv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)


def _wbqp_inputs(k, seed):
    rng = np.random.default_rng(seed)
    q = _configs(k, seed)
    q_des = _configs(k, seed + 1)
    v = rng.standard_normal((k, 18)) * 0.3
    v_des = rng.standard_normal((k, 18)) * 0.3
    f_des = np.zeros((k, 4, 3))
    f_des[..., 2] = 13.741 * 9.81 / 4 + 5.0 * rng.standard_normal((k, 4))
    f_des[..., :2] = 3.0 * rng.standard_normal((k, 4, 2))
    return q, v, q_des, v_des, f_des


def test_compute_torques_matches_jax_for_each_contact_mask(models):
    """All four feet in contact, a diagonal pair in swing, and a stance
    foot measured off the ground (its contact rows masked, its lambda
    pinned), each at two states."""
    jm, pm = models
    wb = jwbqp.WBQPConfig()
    q, v, q_des, v_des, f_des = _wbqp_inputs(6, 4)
    contact = np.repeat(MASKS, 2, axis=0)
    f_des = f_des * contact[..., None]
    ref = jit_per_scenario(lambda *a: jwbqp.compute_torques(jm, wb, *a))(
        q, v, contact, q_des, v_des, f_des)
    got = wbqp.compute_torques(pm, convert.from_wbqp_config(wb), t(q), t(v),
                               t(contact), t(q_des), t(v_des), t(f_des))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TAU_ATOL)
    # the masks matter: the same states with all feet in contact differ
    all_on = wbqp.compute_torques(pm, convert.from_wbqp_config(wb), t(q),
                                  t(v), t(np.ones_like(contact)), t(q_des),
                                  t(v_des), t(f_des))
    assert (all_on - got)[2:].abs().max() > 1e-2


def test_pd_grav_comp_matches_jax(models):
    jm, pm = models
    q, v, q_des, v_des, _ = _wbqp_inputs(4, 9)
    ref = jit_per_scenario(lambda *a: jwbqp.pd_grav_comp(jm, *a))(
        q, v, q_des, v_des)
    got = wbqp.pd_grav_comp(pm, t(q), t(v), t(q_des), t(v_des))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TAU_ATOL)


@functools.cache
def _plan(carrier: bool):
    """Two scenarios planned by create_initial_run on a trot (the port's,
    from the JAX package's initial trajectory), with or without the force
    carrier."""
    jm = ja1.make_a1()
    cfg = dataclasses.replace(CFG, force_carrier=carrier)
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64).at[2].add(-0.007)
    params = jsrb.make_srb_params(jm, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(18))
    feet0 = jrbd.ee_positions(jm, q0)
    traj = jdeft(cfg, jgait.make_trot(cfg), x0, feet0[:, :2])
    st = jsolver.make_state(cfg, traj, jnp.asarray(cfg.ee_box_size,
                                                   jnp.float64))
    pst = convert.from_solver_state(jax.tree.map(lambda a: jnp.stack([a] * 2),
                                                 st), device="cpu")
    pparams = convert.from_srb_params(params, device="cpu")
    x0s = convert.tensor(jnp.stack([x0] * 2), device="cpu")
    x0s[1, 3] += 0.3                    # the second scenario pushed
    feets = convert.tensor(jnp.stack([feet0] * 2), device="cpu")
    x_des = convert.tensor(jnp.stack([jsrb.manifold_to_tangent(x0)] * 2),
                           device="cpu")
    pcfg = convert.from_config(cfg)
    pst, stats = solver.create_initial_run(pcfg, pparams, pst, x0s, feets,
                                           x_des)
    assert bool(stats.solved.all())
    tr = convert.to_numpy(pst.traj)
    jtraj = JTraj(x_man=jnp.asarray(tr.x_man), f_nodes=jnp.asarray(
        tr.f_nodes), footholds=jnp.asarray(tr.footholds),
        sched=JSched(bounds=jnp.asarray(tr.sched.bounds)))
    return cfg, pcfg, params, pparams, jtraj, pst.traj


def _tick_inputs():
    """Two measured states at two times of the trot (t0 = 0), the measured
    contact differing from the scheduled one in the second."""
    q = _configs(2, 11)
    q[:, 2] -= 0.007
    v = np.random.default_rng(12).standard_normal((2, 18)) * 0.2
    measured = np.array([[1, 1, 1, 1], [1, 1, 0, 1]], dtype=bool)
    return q, v, np.array([0.03, 0.21]), np.zeros(2), measured


# The JAX model goes into the jitted references as an argument: closed
# over, its total_mass (jnp.sum of a constant) is folded by XLA in another
# order and comes out one float32 ulp above the link-order sum that the
# eager JAX package and the port use (13.741000 against 13.740999).


@pytest.mark.parametrize("carrier", [False, True],
                         ids=["no_carrier", "carrier"])
def test_targets_from_traj_matches_jax(carrier):
    cfg, pcfg, params, _, jtraj, ptraj = _plan(carrier)
    q, _, tt, t0, _ = _tick_inputs()
    ref = jit_per_scenario(
        lambda m, *a: jmc.targets_from_traj(m, cfg, *a, params.com_offset),
        in_axes=(None, 0, 0, 0, 0))(ja1.make_a1(), jtraj, tt, t0, q)
    got = mpc_controller.targets_from_traj(
        a1.make_a1(device="cpu"), pcfg, ptraj, t(tt), t(t0), t(q),
        convert.tensor(params.com_offset, device="cpu"))
    for g, r in zip(got[:4], ref[:4]):
        assert_close_rel(g, r, 1e-9)
    # the scheduled contact at 0.21 s is the diagonal pair
    assert np.array_equal(got[4].numpy(), np.asarray(ref[4]))
    assert np.array_equal(got[4].numpy(), [[0, 1, 1, 0], [0, 1, 1, 0]])


def test_control_action_matches_jax():
    """control_action_full (torques and motor targets) and control_action
    with the force carrier on, the measured contact differing from the
    scheduled one in the second scenario."""
    cfg, pcfg, params, pparams, jtraj, ptraj = _plan(True)
    wb = jwbqp.WBQPConfig()
    q, v, tt, t0, measured = _tick_inputs()
    ref = jit_per_scenario(
        lambda m, *a: jmc.control_action_full(m, params, cfg, wb, *a),
        in_axes=(None, 0, 0, 0, 0, 0, 0))(ja1.make_a1(), jtraj, q, v, tt,
                                           t0, measured)
    pm, pwb = a1.make_a1(device="cpu"), convert.from_wbqp_config(wb)
    got = mpc_controller.control_action_full(pm, pparams, pcfg, pwb, ptraj,
                                             t(q), t(v), t(tt), t(t0),
                                             t(measured))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=TAU_ATOL)
    for g, r in zip(got[1:3], ref[1:3]):
        assert_close_rel(g, r, 1e-9)
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert not np.array_equal(got[3].numpy(), [[0, 1, 1, 0], [0, 1, 1, 0]])
    tau = mpc_controller.control_action(pm, pparams, pcfg, pwb, ptraj, t(q),
                                        t(v), t(tt), t(t0), t(measured))
    assert torch.equal(tau, got[0])
