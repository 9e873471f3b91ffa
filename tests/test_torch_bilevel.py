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
from torch_jax_common import jit_per_scenario

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
    # one compile of the RTI serves the steps and the captured solution
    step = jit_per_scenario(lambda st, x, ee: jsolver.solve_step(
        CFG, params, st, x, t0, ee, x_des, return_ext=True))
    history = []
    for _ in range(STEPS):
        states, stats, _ = step(states, x0s, feets)
        history.append((states, stats))
    _, _, ext = step(states, x0s, feets)
    grads = jit_per_scenario(
        lambda st, e, x, ee: jbilevel.outer_gradient_at(
            CFG, params, e.traj_lin, x, t0, ee, x_des, st.ee_box, e.sol))(
        states, ext, x0s, feets)
    gres = jit_per_scenario(lambda st, x, ee: jbilevel.gait_opt_update(
        CFG, params, st, x, t0, ee, x_des))(states, x0s, feets)
    return dict(params=params, history=history, grads=grads, gres=gres,
                x_des=x_des, x0s=x0s, feets=feets, t0=t0)


@pytest.fixture(scope="module")
def port_run():
    pr = problem.make_problem(CFG, B, dtype=torch.float64, stretch=STRETCH, device="cpu")
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


# ---------------------------------------------------------------------------
# BFGS curvature, the plain line search and the full-solve outer gradient
# ---------------------------------------------------------------------------

def test_bfgs_update_matches_jax():
    """One damped-BFGS update per scenario against the JAX function, one
    call per scenario: a plain pair, a pair that triggers Powell damping
    (s.y < 0.2 s.B.s), a degenerate pair (s = 0, B unchanged) and a first
    pair on B = 0.  rtol 1e-10."""
    rng = np.random.default_rng(20)
    n = 20
    L = rng.standard_normal((4, n, n))
    Bm = L @ np.swapaxes(L, -1, -2) / n
    Bm[3] = 0.0
    s = 0.1 * rng.standard_normal((4, n))
    y = np.einsum('bij,bj->bi', Bm, s) + 0.05 * rng.standard_normal((4, n))
    y[1] = -0.5 * y[1]
    s[2] = 0.0
    y[3] = 2.0 * s[3]
    got = bilevel._bfgs_update(*(torch.tensor(a) for a in (Bm, s, y)))
    for k in range(4):
        ref = jbilevel._bfgs_update(*(jnp.asarray(a[k]) for a in (Bm, s, y)))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref),
                                   rtol=1e-10, atol=1e-13)
    np.testing.assert_array_equal(got[2].numpy(), Bm[2])
    assert np.abs(got[1].numpy() - Bm[1]).max() > 1e-6
    assert np.linalg.eigvalsh(got[1].numpy()).min() > -1e-10


def test_init_curvature_and_converter_round_trip():
    c = bilevel.init_curvature(CFG, B, dtype=torch.float64, device="cpu")
    jc = jbilevel.init_curvature(CFG, jnp.float64)
    for name in ("B", "theta", "g", "ok"):
        for k in range(B):
            np.testing.assert_array_equal(getattr(c, name)[k].numpy(),
                                          np.asarray(getattr(jc, name)))
    back = convert.to_numpy(convert.from_outer_curvature(jc, device="cpu"))
    assert isinstance(back, bilevel.OuterCurvature)
    assert back.ok.dtype == np.bool_ and back.B.shape == jc.B.shape


@pytest.mark.parametrize("warm", [False, True])
def test_outer_gradient_full_solve_matches_jax_grad(jax_run, port_run, warm):
    """outer_gradient (a full forward solve, then the IFT adjoint) against
    the JAX function, which is jax.grad of the same objective: cold with
    every sweep exact, and from the carried warm start on the
    ipm_exact_every cadence.  Same direction (cosine > 1 - 1e-6) and norm
    to rtol 1e-4, as for outer_gradient_at."""
    jst = jax_run["history"][-1][0]
    st = port_run["history"][-1][0]
    pr = port_run["pr"]
    t0 = jax_run["t0"]
    gj = jit_per_scenario(lambda s_, x, ee: jbilevel.outer_gradient(
        CFG, jax_run["params"], s_.traj, x, t0, ee, jax_run["x_des"],
        s_.ee_box, s_.qp_warm if warm else None))(
        jst, jax_run["x0s"], jax_run["feets"])
    g = bilevel.outer_gradient(CFG, pr.params, st.traj, pr.x0s, pr.t0,
                               pr.feets, pr.x_des, st.ee_box,
                               st.qp_warm if warm else None)
    g, gj = g.reshape(B, -1).numpy(), np.asarray(gj).reshape(B, -1)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    cos = np.sum(g * gj, -1) / (np.linalg.norm(g, axis=-1)
                                * np.linalg.norm(gj, axis=-1))
    assert (cos > 1 - 1e-6).all(), cos
    np.testing.assert_allclose(np.linalg.norm(g, axis=-1),
                               np.linalg.norm(gj, axis=-1), rtol=1e-4)


def test_line_search_matches_jax(jax_run, port_run):
    """The alpha-grid line search over full cold solves along the projected
    step of the outer gradient: same winner (alpha) and solve flags, costs
    to rtol 1e-6, the winner's trajectory to atol 1e-6."""
    jst = jax_run["history"][-1][0]
    st = port_run["history"][-1][0]
    pr = port_run["pr"]
    t0 = jax_run["t0"]
    # no frozen boundary, so that the step moves the imminent touchdowns
    d = bilevel.contact_time_step(
        dataclasses.replace(CFG, gait_freeze_boundaries=0), st.traj.sched,
        port_run["grads"], pr.t0)
    assert float(d.abs().max()) > 1e-3
    res = bilevel.line_search(CFG, pr.params, st, d, pr.x0s, pr.t0, pr.feets,
                              pr.x_des)
    # the JAX function takes a state without a carried warm start only
    jres = jit_per_scenario(lambda tr, box, dd, x, ee: jbilevel.line_search(
        CFG, jax_run["params"],
        jsolver.SolverState(traj=tr, ee_box=box, qp_warm=None), dd, x, t0,
        ee, jax_run["x_des"]))(
        jst.traj, jst.ee_box, jnp.asarray(d.numpy()), jax_run["x0s"],
        jax_run["feets"])
    np.testing.assert_array_equal(res.alpha.numpy(), np.asarray(jres.alpha))
    for name in ("cost", "cost0", "grad_norm"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-6, err_msg=name)
    for name in ("x_man", "f_nodes", "footholds"):
        np.testing.assert_allclose(
            getattr(res.state.traj, name).numpy(),
            np.asarray(getattr(jres.state.traj, name)), rtol=0, atol=1e-6,
            err_msg=name)
    np.testing.assert_allclose(res.state.traj.sched.bounds.numpy(),
                               np.asarray(jres.state.traj.sched.bounds),
                               rtol=0, atol=1e-12)
    assert res.state.qp_warm is None and res.rti_stats is None


def test_gait_opt_update_with_curvature_over_two_ticks(jax_run, port_run):
    """cfg.gait_bfgs with the curvature carry threaded through two
    consecutive gait ticks: the first builds the (theta, g) pair on B = 0,
    the second applies the damped-BFGS update in the projection QP and the
    ratio test.  Same decisions (accepted, alpha) on both ticks; costs,
    trust and the carried curvature to rtol 1e-5 of each array's largest
    entry (the gradient pair's difference enters B)."""
    # no frozen boundary: the first tick's step is accepted and moves
    # theta, so the second tick has a pair (s, y) to update B with
    cfg = dataclasses.replace(CFG, gait_bfgs=True, gait_freeze_boundaries=0)
    jst = jax_run["history"][-1][0]
    st = port_run["history"][-1][0]
    pr = port_run["pr"]
    t0 = jax_run["t0"]
    jstep = jit_per_scenario(
        lambda s_, x, ee, tr, cv: jbilevel.gait_opt_update(
            cfg, jax_run["params"], s_, x, t0, ee, jax_run["x_des"],
            trust=tr, curv=cv))
    jcurv = jax.tree.map(lambda a: jnp.stack([a] * B),
                         jbilevel.init_curvature(cfg, jnp.float64))
    curv = bilevel.init_curvature(cfg, B, dtype=torch.float64, device="cpu")
    jtrust = jnp.full((B,), cfg.trust_region)
    trust = torch.full((B,), cfg.trust_region, dtype=torch.float64)
    for tick in range(2):
        jres = jstep(jst, jax_run["x0s"], jax_run["feets"], jtrust, jcurv)
        res = bilevel.gait_opt_update(cfg, pr.params, st, pr.x0s, pr.t0,
                                      pr.feets, pr.x_des, trust=trust,
                                      curv=curv)
        np.testing.assert_array_equal(res.accepted.numpy(),
                                      np.asarray(jres.accepted), str(tick))
        np.testing.assert_array_equal(res.alpha.numpy(),
                                      np.asarray(jres.alpha), str(tick))
        for name in ("cost", "cost0", "grad_norm", "trust"):
            np.testing.assert_allclose(getattr(res, name).numpy(),
                                       np.asarray(getattr(jres, name)),
                                       rtol=1e-5, atol=1e-9,
                                       err_msg=f"{name} tick {tick}")
        np.testing.assert_array_equal(res.curv.ok.numpy(),
                                      np.asarray(jres.curv.ok))
        for name in ("B", "theta", "g"):
            ref = np.asarray(getattr(jres.curv, name))
            np.testing.assert_allclose(
                getattr(res.curv, name).numpy(), ref, rtol=0,
                atol=1e-5 * max(np.abs(ref).max(), 1e-12),
                err_msg=f"curv.{name} tick {tick}")
        if tick == 0:
            assert bool(res.accepted.any())
        jst, jcurv, jtrust = jres.state, jres.curv, jres.trust
        st, curv, trust = res.state, res.curv, res.trust
    assert float(curv.B.abs().max()) > 0        # the second tick updated B
