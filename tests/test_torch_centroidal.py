"""Port parity, float64, of the centroidal MPC variant
(``mpc/centroidal.py``) and of ``qp.assemble``'s per-node inertia against
the JAX package, on the same inputs made from a numpy seed.

Tolerances: the QP data to rtol 1e-9 of each array's largest entry (the
condensing loop spans ~12 decades, as in tests/test_torch_mpc.py); the node
inertias, IK configurations and defects to 1e-10; solutions of the
interior-point solve and the RTI's carried state to rtol 1e-6 / atol 1e-8
(float64 IPMs of the same math, summed in another order; measured
agreement ~1e-10)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import centroidal as jc, gait as jgait
from bilevel_gait_gen_tpu.mpc import qp as jqp
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory as jdeft
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.mpc import centroidal, qp

torch.set_num_threads(2)

F64 = torch.float64
CFG8 = MPCConfig(num_nodes=8, ipm_iters=25).validate()
# the RTI configuration of tests/test_centroidal.py
CFG6 = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                 samples_per_stance=4, ee_node_start=1, ipm_iters=20,
                 init_run_iters=3, max_ls_iters=6, dt=0.05).validate()
JMODEL = ja1.make_a1()
MODEL = convert.from_robot_model(JMODEL, device="cpu")
Q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
JPARAMS = jsrb.make_srb_params(JMODEL, Q0)
PARAMS = convert.from_srb_params(JPARAMS, device="cpu")
GAITS = {"standing": jgait.make_standing, "trot": jgait.make_trot}


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def stack(objs):
    return jax.tree.map(lambda *a: jnp.stack(a), *objs)


def close_max(port, ref, rtol=1e-9, what=""):
    ref = np.asarray(ref)
    got = convert.to_numpy(port)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max() / scale
    assert err <= rtol, (what, err)


def close(port, ref, rtol=1e-6, atol=1e-8, what=""):
    np.testing.assert_allclose(convert.to_numpy(port), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=what)


def _problem(cfg, gait, B=2, seed=0, bend=0.1):
    """B scenarios: the stand with the joints moved from a seed, the SRB
    state reconstructed there, the default trajectory on ``gait``; node
    configurations bent along the horizon (a leg lifting), so that the
    per-node inertias differ."""
    rng = np.random.default_rng(seed)
    N = cfg.num_nodes
    out = []
    for i in range(B):
        q0 = np.asarray(Q0).copy()
        q0[7:] += 0.05 * rng.standard_normal(q0.size - 7)
        q0 = jnp.asarray(q0)
        x0 = jsrb.reconstruct_state(JPARAMS, q0, jnp.zeros(JMODEL.nv))
        feet0 = jrbd.ee_positions(JMODEL, q0)
        traj = jdeft(cfg, GAITS[gait](cfg), x0, feet0[:, :2])
        cfgs = np.stack([np.asarray(q0)] * (N + 1))
        cfgs[:, 7:] += bend * np.linspace(0, 1, N + 1)[:, None] \
            * rng.standard_normal(q0.size - 7)[None]
        out.append(dict(q0=q0, x0=x0, feet0=feet0, traj=traj,
                        configs=jnp.asarray(cfgs),
                        x_des=jsrb.manifold_to_tangent(x0),
                        box=jnp.asarray(cfg.ee_box_size, jnp.float64)))
    return out


def _port(sc):
    """The port's batched operands of a list of scenarios."""
    return dict(traj=convert.from_trajectory(stack([s["traj"] for s in sc]),
                                             device="cpu"),
                **{k: t(np.stack([np.asarray(s[k]) for s in sc]))
                   for k in ("q0", "x0", "feet0", "configs", "x_des", "box")})


def _jax(sc):
    """The JAX package's operands of the same scenarios, stacked for
    ``jax.vmap``."""
    return {k: stack([s[k] for s in sc]) for k in sc[0]}


# each JAX function jitted once, vmapped over the scenarios
J_INERTIA = jax.jit(jax.vmap(lambda c: jc.node_inertias(JMODEL, c)))
J_ASSEMBLE = jax.jit(jax.vmap(
    lambda tr, x0, t0, f0, xd, box, irs: jqp.assemble(
        CFG8, JPARAMS, tr, x0, t0, f0, xd, box, node_inertia=irs)))
J_ASSEMBLE_PLAIN = jax.jit(jax.vmap(
    lambda tr, x0, t0, f0, xd, box: jqp.assemble(CFG8, JPARAMS, tr, x0, t0,
                                                 f0, xd, box)))


def _centroidal_and_solve(*a):
    cqp = jc.assemble_centroidal(CFG8, JMODEL, JPARAMS, *a)
    return cqp, jc.solve_centroidal(cqp, iters=15, tol=1e-10)[:2]


# the centroidal QP and its solve in one compile (the solve is cheap to run)
J_CENTROIDAL = jax.jit(jax.vmap(_centroidal_and_solve))
J_IK = jax.jit(jax.vmap(lambda tr, t0, q: jc.ik_node_configs(
    JMODEL, CFG6, JPARAMS, tr, t0, q)))
J_DEFECT = jax.jit(jax.vmap(lambda irs, xs, tr, t0: jc._defect_l1_centroidal(
    CFG6, JPARAMS, irs, xs, tr.f_nodes, tr.footholds, tr.sched.bounds, t0)))
# one compile serves the initial run and the shifting steps (see
# test_rti_initial_run_and_shifting_steps_match_jax)
J_STEP = jax.jit(jax.vmap(lambda st, x0, t0, f0, xd: jc.solve_centroidal_step(
    CFG6, JMODEL, JPARAMS, st, x0, t0, f0, xd)))


def test_node_inertias_match_jax():
    sc = _problem(CFG8, "trot", bend=0.5)
    got = centroidal.node_inertias(MODEL, _port(sc)["configs"])
    close(got, J_INERTIA(_jax(sc)["configs"]), rtol=1e-10, atol=1e-13)
    assert float((got[0, -1] - got[0, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("with_inertia", [False, True])
def test_assemble_node_inertia_matches_jax(with_inertia):
    """qp.assemble with and without the per-node inertia, on the trot."""
    sc = _problem(CFG8, "trot", bend=0.4)
    P, J = _port(sc), _jax(sc)
    t0 = t([0.0, 0.13])
    Irs = centroidal.node_inertias(MODEL, P["configs"])
    got = qp.assemble(CFG8, PARAMS, P["traj"], P["x0"], t0, P["feet0"],
                      P["x_des"], P["box"],
                      node_inertia=Irs if with_inertia else None)
    args = (J["traj"], J["x0"], jnp.asarray(t0.numpy()), J["feet0"],
            J["x_des"], J["box"])
    ref = (J_ASSEMBLE(*args, J_INERTIA(J["configs"])) if with_inertia
           else J_ASSEMBLE_PLAIN(*args))
    for k in range(len(sc)):
        for f in ("H", "q", "A", "b", "G", "h", "S", "c"):
            close_max(getattr(got, f)[k], getattr(ref, f)[k], what=f)
    if with_inertia:
        plain = qp.assemble(CFG8, PARAMS, P["traj"], P["x0"], t0,
                            P["feet0"], P["x_des"], P["box"])
        assert float((plain.H - got.H).abs().max()) > 1e-6


@pytest.mark.parametrize("gait", ["standing", "trot"])
def test_assemble_centroidal_matches_jax(gait):
    """The centroidal QP (FK rows carry swing velocities on the trot)."""
    sc = _problem(CFG8, gait)
    P, J = _port(sc), _jax(sc)
    t0 = t([0.0, 0.13])
    got = centroidal.assemble_centroidal(
        CFG8, MODEL, PARAMS, P["traj"], P["configs"], P["x0"], t0,
        P["feet0"], P["x_des"], P["box"])
    ref = J_CENTROIDAL(J["traj"], J["configs"], J["x0"],
                       jnp.asarray(t0.numpy()), J["feet0"], J["x_des"],
                       J["box"])[0]
    for k in range(len(sc)):
        for f in ("H", "q", "A", "b", "G", "h"):
            close_max(getattr(got, f)[k], getattr(ref, f)[k], what=f)
    assert got.H.shape[-1] == got.n_spline + CFG8.num_nodes * 12
    if gait == "trot":
        fk_b = got.b[:, got.base.b.shape[-1]:]
        assert float(fk_b.abs().max()) > 1e-2


def test_solve_centroidal_matches_jax():
    sc = _problem(CFG8, "trot")
    P, J = _port(sc), _jax(sc)
    z = torch.zeros(2, dtype=F64)
    cqp = centroidal.assemble_centroidal(
        CFG8, MODEL, PARAMS, P["traj"], P["configs"], P["x0"], z,
        P["feet0"], P["x_des"], P["box"])
    u, vj, sol = centroidal.solve_centroidal(cqp, iters=15, tol=1e-10)
    ju, jvj = J_CENTROIDAL(J["traj"], J["configs"], J["x0"], jnp.zeros(2),
                           J["feet0"], J["x_des"], J["box"])[1]
    close(u, ju, what="u")
    close(vj, jvj, what="vj")
    assert float(sol.gap.max()) < 1e-4 and float(sol.pri_res.max()) < 1e-4


@pytest.mark.parametrize("gait", ["standing", "trot"])
def test_ik_configs_and_defect_match_jax(gait):
    sc = _problem(CFG6, gait)
    P, J = _port(sc), _jax(sc)
    t0 = t([0.0, 0.2])
    got = centroidal.ik_node_configs(MODEL, CFG6, PARAMS, P["traj"], t0,
                                     P["q0"])
    ref = J_IK(J["traj"], jnp.asarray(t0.numpy()), J["q0"])
    close(got, ref, rtol=1e-10, atol=1e-12)
    # the defect of a perturbed state trajectory with these inertias
    xs = convert.to_numpy(centroidal.srb.manifold_to_tangent(
        P["traj"].x_man))
    xs = xs + 0.01 * np.random.default_rng(5).standard_normal(xs.shape)
    dp = centroidal._defect_l1_centroidal(
        CFG6, PARAMS, centroidal.node_inertias(MODEL, got), t(xs),
        P["traj"].f_nodes, P["traj"].footholds, P["traj"].sched.bounds, t0)
    dj = J_DEFECT(J_INERTIA(ref), jnp.asarray(xs), J["traj"],
                  jnp.asarray(t0.numpy()))
    close(dp, dj, rtol=1e-10, atol=0)


def _compare_state(st, jst, what):
    for f in ("x_man", "f_nodes", "footholds"):
        close(getattr(st.traj, f), getattr(jst.traj, f), what=f"{what} {f}")
    close(st.traj.sched.bounds, jst.traj.sched.bounds, what=what)
    close(st.ee_box, jst.ee_box, what=f"{what} ee_box")
    close(st.configs, jst.configs, what=f"{what} configs")
    close(st.vj, jst.vj, what=f"{what} vj")
    assert st.qp_warm is None and jst.qp_warm is None


def _compare_stats(stats, jstats, what):
    for f in ("cost", "merit", "defect_l1", "step_norm", "alpha"):
        close(getattr(stats, f), getattr(jstats, f), atol=1e-7,
              what=f"{what} {f}")
    np.testing.assert_array_equal(stats.solved.numpy(),
                                  np.asarray(jstats.solved), err_msg=what)


@pytest.mark.parametrize("gait", ["standing", "trot"])
def test_rti_initial_run_and_shifting_steps_match_jax(gait):
    """create_initial_run_centroidal (3 SQP iterations), then 3 steps at
    t = 0.05, 0.10, 0.15 with the window shifting, both scenarios held to
    the JAX package step by step: the carried state (trajectory, EE box,
    node configurations, joint velocities) and the stats; the warm start
    stays inert (qp_warm None on both sides), and the standing plan passes
    the reference's acceptance bar (tests/test_centroidal.py).

    The JAX package's create_initial_run_centroidal is a scan of
    solve_centroidal_step(shift_window=False) at t0 = 0.  At t0 = 0 no
    cycle of the schedule is past, so the window shift is the identity
    (asserted below), and the JAX side runs the scan's body as
    init_run_iters calls of the one compiled shifting step: tracing the
    step dominates this test's time, and a second trace for the scan would
    double it."""
    sc = _problem(CFG6, gait, bend=0.0)
    P, J = _port(sc), _jax(sc)
    st = centroidal.make_centroidal_state(CFG6, MODEL, P["traj"], P["box"],
                                          P["q0"])
    st, stats = centroidal.create_initial_run_centroidal(
        CFG6, MODEL, PARAMS, st, P["x0"], P["feet0"], P["x_des"])
    jst = jax.vmap(lambda tr, box, q0: jc.make_centroidal_state(
        CFG6, JMODEL, tr, box, q0))(J["traj"], J["box"], J["q0"])
    zero = jnp.full((2,), 0.0, jnp.float64)
    for k in range(len(sc)):
        sched = jax.tree.map(lambda a: a[k], J["traj"].sched)
        assert int(jgait.past_cycles(sched, zero[k]).max()) == 0
        np.testing.assert_array_equal(
            jgait.advance_window(sched, zero[k], CFG6).bounds, sched.bounds)
    for _ in range(CFG6.init_run_iters):
        jst, jstats = J_STEP(jst, J["x0"], zero, J["feet0"], J["x_des"])
    _compare_state(st, jst, "init")
    _compare_stats(stats, jstats, "init")
    for i in range(3):
        t0 = 0.05 * (i + 1)
        st, stats = centroidal.solve_centroidal_step(
            CFG6, MODEL, PARAMS, st, P["x0"], torch.full((2,), t0, dtype=F64),
            P["feet0"], P["x_des"])
        jst, jstats = J_STEP(jst, J["x0"], jnp.full((2,), t0, jnp.float64),
                             J["feet0"], J["x_des"])
        _compare_state(st, jst, f"step {i}")
        _compare_stats(stats, jstats, f"step {i}")
        if gait == "standing":
            assert bool(stats.solved.all())
            assert float(stats.alpha.min()) >= 0.5
            assert float(stats.defect_l1.max()) < 1e-2
    assert float(st.vj.abs().max()) <= float(MODEL.velocity_limit[0])


def test_warm_start_is_inert_as_in_the_reference():
    """make_centroidal_state never seeds qp_warm (the reference's inert
    warm start): the JAX state has none, the converted state has none, and
    every port step solves cold and carries None on."""
    sc = _problem(CFG6, "standing", B=1)
    s = sc[0]
    jst = jc.make_centroidal_state(CFG6, JMODEL, s["traj"], s["box"], s["q0"])
    assert jst.qp_warm is None
    st = convert.from_centroidal_state(stack([jst]), device="cpu")
    assert st.qp_warm is None and st.vj.shape == (1, CFG6.num_nodes,
                                                   MODEL.num_joints)
    P = _port(sc)
    np.testing.assert_array_equal(st.configs.numpy(), np.repeat(
        np.asarray(s["q0"])[None, None], CFG6.num_nodes + 1, 1))
    for shift in (False, True):
        st, _ = centroidal.solve_centroidal_step(
            CFG6, MODEL, PARAMS, st, P["x0"],
            torch.full((1,), 0.05, dtype=F64),
            P["feet0"], P["x_des"], shift_window=shift)
        assert st.qp_warm is None


J_CENTROIDAL32 = jax.jit(jax.vmap(
    lambda tr, c, x0, t0, f0, xd, box: jc.assemble_centroidal(
        CFG8, JMODEL, jax.tree.map(lambda a: a.astype(jnp.float32), JPARAMS),
        tr, c, x0, t0, f0, xd, box).b))


def test_float32_node_below_a_phase_bound_straddles_like_jax():
    """A fault of the reference, reproduced: the FK rows' foot velocity is
    a forward difference, (f(t + 1e-4) - f(t)) / 1e-4, and the standing
    gait chains its stances through zero-length swings.  In float32 a node
    time can round to one ulp below such a bound: the A1 standing schedule
    at N = 20 has the bound 0.90000004 where t0 + 15 dt at t0 = 0.15 is
    0.89999998, so the difference steps from one stance slot's foothold to
    the next and a gap of centimetres between them reads as a foot velocity
    of hundreds of m/s, past every joint velocity bound (the centroidal
    RTI on the card meets it there).  Here the same situation at N = 8
    (node 3 at t0 = 0.15, the bound one ulp above its float32 time, the
    later slots' footholds 3 cm away): the JAX package builds the same
    rows from the same float32 inputs, rtol 1e-4."""
    sc = _problem(CFG8, "standing", bend=0.0)
    J = _jax(sc)
    t3 = (torch.full((1,), 0.15)[:, None] + CFG8.dt * torch.arange(
        CFG8.num_nodes, dtype=torch.float32))[0, 3]
    bound = np.nextafter(np.float32(t3), np.float32(1.0))
    b = np.asarray(J["traj"].sched.bounds, np.float32).copy()
    b[..., 1:3] = bound                       # the chained stance at 0.3
    fh = np.asarray(J["traj"].footholds, np.float32).copy()
    fh[:, :, 1:, 0] += 0.03                   # later slots 3 cm ahead
    traj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), J["traj"])
    traj = type(traj)(x_man=traj.x_man, f_nodes=traj.f_nodes,
                      footholds=jnp.asarray(fh),
                      sched=type(traj.sched)(bounds=jnp.asarray(b)))
    rest = [jnp.asarray(J[k], jnp.float32) for k in ("configs", "x0")] + [
        jnp.full((2,), 0.15, jnp.float32)] + [
        jnp.asarray(J[k], jnp.float32) for k in ("feet0", "x_des", "box")]
    got = centroidal.assemble_centroidal(
        CFG8, MODEL, convert.from_srb_params(JPARAMS, device="cpu",
                                             dtype=torch.float32),
        convert.from_trajectory(traj, device="cpu", dtype=torch.float32),
        *(torch.tensor(np.asarray(a)) for a in rest))
    p0 = got.base.b.shape[-1]
    fk = got.b[:, p0:]
    assert float(fk.abs().max()) > 200.0
    ref = np.asarray(J_CENTROIDAL32(traj, *rest))[:, p0:]
    np.testing.assert_allclose(fk.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
