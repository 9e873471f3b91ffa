"""The second slice as a whole, at a small size: ``create_initial_run`` (the
cold start, every sweep an exact refresh) and then one cadence cycle (real
time iterations, then ``gait_opt_update``), all with ``ipm_inverse="gj"``,
against the JAX package.

The JAX package runs its Gauss-Jordan kernel in Pallas interpret mode
(``pk.INTERPRET = True`` for the duration of the run and restored after;
off the TPU it otherwise silently runs the Cholesky and the comparison
would say nothing about the Gauss-Jordan path).  The port, on CPU tensors,
runs the kernel's plain version at the same block width (128).

float64, two perturbed scenarios, N=6, ``init_run_iters=3``, a cycle of
three real-time iterations and one gait update.  Tolerances as for the
Cholesky cadence in tests/test_torch_bilevel.py: identical solve flags and
line-search alphas, trajectories to atol 1e-6, stats to rtol 1e-5 (the
shifted inverse is deflated to ~1e-12 residuals on both sides, so the
sweeps see the same matrices to rounding)."""
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
from bilevel_gait_gen_tpu.ops import pallas_kernels as pk
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert, problem
from bilevel_gait_gen_tpu_torch.mpc import bilevel, solver
from bilevel_gait_gen_tpu_torch.ops import kernels
from torch_jax_common import jit_per_scenario

torch.set_num_threads(2)

JCFG = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                 samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                 ipm_exact_every=3, max_ls_iters=4, dt=0.05,
                 ipm_grad_polish=2, ls_ipm_iters=16, init_run_iters=3,
                 gait_freeze_boundaries=0, ipm_inverse="gj").validate()
CFG = convert.from_config(JCFG)
B, STRETCH, RTIS = 2, 1.3, 3


@pytest.fixture(scope="module")
def jax_run():
    old = pk.INTERPRET
    pk.INTERPRET = True
    try:
        model = ja1.make_a1()
        q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
        params = jsrb.make_srb_params(model, q0)
        x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(model.nv))
        feet0 = jrbd.ee_positions(model, q0)
        sched = jgait.GaitSchedule(
            bounds=jgait.make_trot(JCFG).bounds * STRETCH)
        traj = default_trajectory(JCFG, sched, x0, feet0[:, :2])
        state = jsolver.make_state(
            JCFG, traj, jnp.asarray(JCFG.ee_box_size, jnp.float64))
        x_des = jsrb.manifold_to_tangent(
            x0.at[3:6].set(0.0).at[10:13].set(0.0))
        x0s = x0[None] + jnp.asarray(problem.perturbations(B, seed=0))
        states = jax.tree.map(lambda a: jnp.stack([a] * B), state)
        t0 = jnp.asarray(0.0)
        init = jit_per_scenario(lambda st, x: jsolver.create_initial_run(
            JCFG, params, st, x, feet0, x_des, t0), jit_fn=jax.jit)
        step = jit_per_scenario(lambda st, x: jsolver.solve_step(
            JCFG, params, st, x, t0, feet0, x_des), jit_fn=jax.jit)
        gait_up = jit_per_scenario(lambda st, x: jbilevel.gait_opt_update(
            JCFG, params, st, x, t0, feet0, x_des), jit_fn=jax.jit)
        states, init_stats = init(states, x0s)
        history = [(states, init_stats)]
        for _ in range(RTIS):
            states, stats = step(states, x0s)
            history.append((states, stats))
        return dict(history=history, gres=gait_up(states, x0s))
    finally:
        pk.INTERPRET = old


@pytest.fixture(scope="module")
def port_run():
    pr = problem.make_problem(CFG, B, dtype=torch.float64, stretch=STRETCH,
                              device="cpu")
    calls = []
    spd = kernels.spd_inverse
    kernels.spd_inverse = lambda M, **kw: calls.append(1) or spd(M, **kw)
    try:
        st, stats = solver.create_initial_run(CFG, pr.params, pr.states,
                                              pr.x0s, pr.feets, pr.x_des,
                                              pr.t0)
        n_init = len(calls)
        history = [(st, stats)]
        for _ in range(RTIS):
            st, stats = solver.solve_step(CFG, pr.params, st, pr.x0s, pr.t0,
                                          pr.feets, pr.x_des)
            history.append((st, stats))
        n_rti = len(calls) - n_init
        gres = bilevel.gait_opt_update(CFG, pr.params, st, pr.x0s, pr.t0,
                                       pr.feets, pr.x_des)
    finally:
        kernels.spd_inverse = spd
    return dict(history=history, gres=gres, n_init=n_init, n_rti=n_rti,
                n_all=len(calls))


def test_gj_inverse_counts_of_the_slice(port_run):
    """Where the path reaches the Gauss-Jordan inverse: the start point and
    every sweep of each cold-start iteration (1 + ipm_iters), the start
    point and the exact sweeps 0, 1, 3, 6 of each real-time iteration, and
    in the gait update the embedded iteration, the polish's start point and
    two exact sweeps, the adjoint, and the lanes' start point and sweeps."""
    assert port_run["n_init"] == CFG.init_run_iters * (1 + CFG.ipm_iters)
    assert port_run["n_rti"] == RTIS * 5
    assert port_run["n_all"] > port_run["n_init"] + port_run["n_rti"] + 5 + 4


@pytest.mark.parametrize("k", range(1 + RTIS),
                         ids=["cold_start"] + [f"rti{i}" for i in range(RTIS)])
def test_gj_slice_states_match_jax(jax_run, port_run, k):
    jst, jstats = jax_run["history"][k]
    st, stats = port_run["history"][k]
    if k == 0:
        # the cold start passes its gate; a later real-time iteration that
        # starts at the optimum may take no step and fail it, on both sides
        assert bool(stats.solved.all())
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
    for f in dataclasses.fields(stats):
        if f.name in ("solved", "alpha"):
            continue
        np.testing.assert_allclose(getattr(stats, f.name).numpy(),
                                   np.asarray(getattr(jstats, f.name)),
                                   rtol=1e-5, atol=1e-8, err_msg=f.name)


def test_gj_slice_gait_update_matches_jax(jax_run, port_run):
    res, jres = port_run["gres"], jax_run["gres"]
    np.testing.assert_array_equal(res.accepted.numpy(),
                                  np.asarray(jres.accepted))
    np.testing.assert_array_equal(res.alpha.numpy(), np.asarray(jres.alpha))
    assert bool(res.accepted.any())
    for name in ("cost", "cost0", "grad_norm", "trust"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-5, atol=1e-8, err_msg=name)
    np.testing.assert_allclose(res.state.traj.sched.bounds.numpy(),
                               np.asarray(jres.state.traj.sched.bounds),
                               rtol=0, atol=1e-8)
