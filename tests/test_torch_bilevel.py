"""Port parity, float64, of the real-time iteration (solver.solve_step) and
the bilevel gait update (bilevel.gait_opt_update, with its outer gradient)
against the JAX package, on the small configuration of
tests/test_parallel.py and three perturbed scenarios.

Tolerances: after three chained RTIs the trajectories agree to atol 1e-6
and the stats to rtol 1e-6 (measured ~1e-10: the same sweeps in float64,
with interior-point iterates converged to ~1e-9 gaps whose last digits
differ); the solve flags and line-search alphas must be identical.  The
outer gradient must point the same way (cosine > 1 - 1e-6) and the gait
update must take the same decisions (accepted, alpha) with objectives to
rtol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import bilevel as jbilevel, gait as jgait
from bilevel_gait_gen_tpu.mpc import solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert, problem
from bilevel_gait_gen_tpu_torch.mpc import bilevel, solver

torch.set_num_threads(2)

# the small config of tests/test_parallel.py; 16-sweep lanes so that the
# cold lane solves pass the quality gate at this size, and a stretched
# schedule so that the gait step has something to move
CFG = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                max_ls_iters=4, dt=0.05, ipm_grad_polish=2,
                ls_ipm_iters=16).validate()
B, STRETCH, STEPS = 3, 1.3, 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX cadence: STEPS vmapped RTIs, then the outer gradient at the
    next RTI's captured solution, and one gait update."""
    model = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    params = jsrb.make_srb_params(model, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(model.nv))
    feet0 = jrbd.ee_positions(model, q0)
    sched = jgait.GaitSchedule(bounds=jgait.make_trot(CFG).bounds * STRETCH)
    traj = default_trajectory(CFG, sched, x0, feet0[:, :2])
    state = jsolver.make_state(CFG, traj,
                               jnp.asarray(CFG.ee_box_size, jnp.float64))
    x_des = jsrb.manifold_to_tangent(x0.at[3:6].set(0.0).at[10:13].set(0.0))
    x0s = x0[None] + jnp.asarray(problem.perturbations(B, seed=0))
    states = jax.tree.map(lambda a: jnp.stack([a] * B), state)
    feets = jnp.stack([feet0] * B)
    t0 = jnp.asarray(0.0)
    step = jax.jit(jax.vmap(lambda st, x, ee: jsolver.solve_step(
        CFG, params, st, x, t0, ee, x_des)))
    history = []
    for _ in range(STEPS):
        states, stats = step(states, x0s, feets)
        history.append((states, stats))

    def grad_at(st, x, ee):
        _, _, ext = jsolver.solve_step(CFG, params, st, x, t0, ee, x_des,
                                       return_ext=True)
        return jbilevel.outer_gradient_at(CFG, params, ext.traj_lin, x, t0,
                                          ee, x_des, st.ee_box, ext.sol)

    grads = jax.jit(jax.vmap(grad_at))(states, x0s, feets)
    gres = jax.jit(jax.vmap(lambda st, x, ee: jbilevel.gait_opt_update(
        CFG, params, st, x, t0, ee, x_des)))(states, x0s, feets)
    return dict(params=params, history=history, grads=grads, gres=gres,
                x_des=x_des)


@pytest.fixture(scope="module")
def port_run():
    pr = problem.make_problem(CFG, B, dtype=torch.float64, stretch=STRETCH)
    st = pr.states
    history = []
    for _ in range(STEPS):
        st, stats = solver.solve_step(CFG, pr.params, st, pr.x0s, pr.t0,
                                      pr.feets, pr.x_des)
        history.append((st, stats))
    _, _, ext = solver.solve_step(CFG, pr.params, st, pr.x0s, pr.t0,
                                  pr.feets, pr.x_des, return_ext=True)
    grads = bilevel.outer_gradient_at(CFG, pr.params, ext.traj_lin, pr.x0s,
                                      pr.t0, pr.feets, pr.x_des, st.ee_box,
                                      ext.sol)
    gres = bilevel.gait_opt_update(CFG, pr.params, st, pr.x0s, pr.t0,
                                   pr.feets, pr.x_des)
    return dict(pr=pr, history=history, grads=grads, gres=gres)


def test_problem_matches_jax_bench_problem(jax_run, port_run):
    """make_problem builds the bench problem the JAX side builds."""
    pr = port_run["pr"]
    for name in ("mass", "inertia", "hip_offset", "com_offset"):
        np.testing.assert_allclose(
            getattr(pr.params, name).numpy(),
            np.asarray(getattr(jax_run["params"], name)), rtol=1e-12)
    np.testing.assert_allclose(pr.x_des[0].numpy(),
                               np.asarray(jax_run["x_des"]), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("k", range(STEPS))
def test_solve_step_chain_matches_jax(jax_run, port_run, k):
    jst, jstats = jax_run["history"][k]
    st, stats = port_run["history"][k]
    np.testing.assert_array_equal(stats.solved.numpy(),
                                  np.asarray(jstats.solved))
    np.testing.assert_array_equal(stats.alpha.numpy(),
                                  np.asarray(jstats.alpha))
    for name in ("x_man", "f_nodes", "footholds"):
        np.testing.assert_allclose(getattr(st.traj, name).numpy(),
                                   np.asarray(getattr(jst.traj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(st.traj.sched.bounds.numpy(),
                                  np.asarray(jst.traj.sched.bounds))
    np.testing.assert_array_equal(st.ee_box.numpy(), np.asarray(jst.ee_box))
    for f in dataclasses.fields(stats):
        if f.name in ("solved", "alpha"):
            continue
        np.testing.assert_allclose(getattr(stats, f.name).numpy(),
                                   np.asarray(getattr(jstats, f.name)),
                                   rtol=1e-6, atol=1e-9, err_msg=f.name)
    np.testing.assert_allclose(st.qp_warm.x.numpy(),
                               np.asarray(jst.qp_warm.x), rtol=0, atol=1e-6)


def test_outer_gradient_matches_jax(jax_run, port_run):
    g = port_run["grads"].reshape(B, -1).numpy()
    gj = np.asarray(jax_run["grads"]).reshape(B, -1)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    cos = np.sum(g * gj, -1) / (np.linalg.norm(g, axis=-1)
                                * np.linalg.norm(gj, axis=-1))
    assert (cos > 1 - 1e-6).all(), cos
    np.testing.assert_allclose(np.linalg.norm(g, axis=-1),
                               np.linalg.norm(gj, axis=-1), rtol=1e-4)


def test_gait_opt_update_matches_jax(jax_run, port_run):
    res, jres = port_run["gres"], jax_run["gres"]
    np.testing.assert_array_equal(res.accepted.numpy(),
                                  np.asarray(jres.accepted))
    np.testing.assert_array_equal(res.alpha.numpy(), np.asarray(jres.alpha))
    for name in ("cost", "cost0", "grad_norm", "trust"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(res.rti_stats.solved.numpy(),
                                  np.asarray(jres.rti_stats.solved))
    np.testing.assert_allclose(res.state.traj.sched.bounds.numpy(),
                               np.asarray(jres.state.traj.sched.bounds),
                               rtol=0, atol=1e-9)
    assert np.isfinite(res.win_obj.numpy()).all()
