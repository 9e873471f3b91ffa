"""Port parity, float64, of the ADMM backend (``ops/admm.py``) and of
``solve_step`` on it, against the JAX package: the cases of
tests/test_admm.py, each held to the JAX function on the same inputs made
from a numpy seed, and to that test's own bar (against the interior-point
solve, here the port's, which tests/test_torch_pdip.py holds to the JAX
package's).

Tolerances: iterates of the same float64 iteration in another order of
summation, rtol 1e-7 / atol 1e-9 (measured ~1e-12), the same iteration
counts; gradients as test_solve_primal_gradient_matches_jax_vjp_and_fd
says (the reference's adjoint is conditioned ~1e14); the RTI on the ADMM
backend to rtol 1e-6 / atol 1e-8."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait, solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory as jdeft
from bilevel_gait_gen_tpu.ops import admm as jadmm, pdip as jpdip
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.mpc import solver
from bilevel_gait_gen_tpu_torch.ops import admm, pdip

torch.set_num_threads(2)

F64 = torch.float64


def random_qp(rng, n=20, m=15, p=4):
    """tests/test_admm.py's random QP (numpy arrays)."""
    R = rng.standard_normal((n, n))
    H = R @ R.T + n * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((p, n))
    x = rng.standard_normal(n)
    b = A @ x
    G = rng.standard_normal((m, n))
    h = G @ x + np.abs(rng.standard_normal(m)) + 0.1
    return H, q, A, b, G, h


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(port, ref, rtol=1e-7, atol=1e-9, what=""):
    np.testing.assert_allclose(convert.to_numpy(port), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=what)


def _same_solution(sol, jsol, k=None, what=""):
    for f in ("x", "z", "y", "pri_res", "dua_res"):
        got = getattr(sol, f)
        close(got if k is None else got[k], getattr(jsol, f),
              what=f"{what} {f}")
    got = sol.iters if k is None else sol.iters[k]
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  np.asarray(jsol.iters), err_msg=what)


def _two_sided(qp):
    """(port [1, ...] tensors, JAX arrays) of a one-sided QP, two-sided."""
    jargs = jadmm.from_onesided(*map(jnp.asarray, qp))
    pargs = admm.from_onesided(*(t(a)[None] for a in qp))
    return pargs, jargs


def test_solve_matches_jax_and_pdip():
    qp = random_qp(np.random.default_rng(0))
    pargs, jargs = _two_sided(qp)
    sol = admm.solve(*pargs, iters=2000, tol=1e-9)
    jsol = jadmm.solve(*jargs, iters=2000, tol=1e-9)
    _same_solution(sol, jax.tree.map(lambda a: a[None], jsol))
    ip = pdip.solve(*(t(a)[None] for a in qp), iters=30, tol=1e-11)
    np.testing.assert_allclose(sol.x.numpy(), ip.x.numpy(), atol=2e-4)


def test_warm_start_matches_jax_and_saves_iterations():
    qp = random_qp(np.random.default_rng(1))
    pargs, jargs = _two_sided(qp)
    cold = admm.solve(*pargs, iters=2000, tol=1e-8)
    jcold = jadmm.solve(*jargs, iters=2000, tol=1e-8)
    P, q, A, l, u = pargs
    jP, jq, jA, jl, ju = jargs
    warm = admm.solve(P, q + 0.01, A, l, u, iters=2000, tol=1e-8, warm=cold)
    jwarm = jadmm.solve(jP, jq + 0.01, jA, jl, ju, iters=2000, tol=1e-8,
                        warm=jcold)
    _same_solution(warm, jax.tree.map(lambda a: a[None], jwarm), what="warm")
    cold2 = admm.solve(P, q + 0.01, A, l, u, iters=2000, tol=1e-8)
    assert int(warm.iters[0]) < int(cold2.iters[0])
    np.testing.assert_allclose(warm.x.numpy(), cold2.x.numpy(), atol=1e-5)


def test_batched_matches_jax_vmap_and_pdip():
    """Six QPs in one batch: each scenario freezes at its own iteration,
    as under the JAX package's vmap."""
    rng = np.random.default_rng(2)
    qps = [random_qp(rng) for _ in range(6)]
    stacked = [np.stack(z) for z in zip(*qps)]
    sol = admm.solve(*admm.from_onesided(*map(t, stacked)), iters=1500,
                     tol=1e-8)
    jsol = jax.vmap(lambda *a: jadmm.solve(*jadmm.from_onesided(*a),
                                           iters=1500, tol=1e-8))(
        *map(jnp.asarray, stacked))
    _same_solution(sol, jsol, what="batched")
    assert len(set(sol.iters.tolist())) > 1
    ip = pdip.solve(*map(t, stacked), iters=30, tol=1e-11)
    np.testing.assert_allclose(sol.x.numpy(), ip.x.numpy(), atol=5e-4)


@pytest.mark.parametrize("warm_kind", ["admm", "pdip"])
def test_solve_onesided_matches_jax(warm_kind):
    """The drop-in form: cold, then warm-started from an ADMMSolution or a
    pdip QPSolution (its x, y and lam), as solve_step hands either."""
    qp = random_qp(np.random.default_rng(4))
    port_qp = [t(a)[None] for a in qp]
    jqp = list(map(jnp.asarray, qp))
    got = admm.solve_onesided(*port_qp, iters=800, tol=1e-9)
    ref = jadmm.solve_onesided(*jqp, iters=800, tol=1e-9)
    for f in ("x", "y", "lam", "s", "gap", "pri_res", "dua_res"):
        close(getattr(got, f)[0], getattr(ref, f), what=f)
    if warm_kind == "admm":
        pw = admm.solve(*admm.from_onesided(*port_qp), iters=300, tol=1e-6)
        jw = jadmm.solve(*jadmm.from_onesided(*jqp), iters=300, tol=1e-6)
    else:
        # a few interior-point sweeps, handed to both packages
        pw = pdip.solve(*port_qp, iters=6, tol=1e-6)
        jw = jpdip.QPSolution(**{
            f.name: jnp.asarray(getattr(pw, f.name)[0].numpy())
            for f in dataclasses.fields(pw)})
    q2 = [a for a in port_qp]
    q2[1] = q2[1] + 0.02
    got = admm.solve_onesided(*q2, iters=800, tol=1e-9, warm=pw)
    ref = jadmm.solve_onesided(jqp[0], jqp[1] + 0.02, *jqp[2:], iters=800,
                               tol=1e-9, warm=jw)
    for f in ("x", "y", "lam", "s", "gap", "pri_res", "dua_res"):
        close(getattr(got, f)[0], getattr(ref, f), what=f"warm {f}")
    assert int(got.iters[0]) == int(ref.iters)


@pytest.mark.parametrize("w_act", [None, 1e4], ids=["default", "w1e4"])
def test_adjoint_from_the_same_solution_matches_jax(w_act):
    """_solve_bwd on both sides from the JAX package's solution: with the
    reference's penalty w_act = 0.01 / eps (condition ~1e14, see below) to
    1e-2 of each cotangent's max (measured ~4e-3), with w_act = 1e4 (well
    conditioned) to rtol 1e-6 / atol 1e-9."""
    rng = np.random.default_rng(3)
    qp = random_qp(rng)
    w = rng.standard_normal(qp[1].shape[-1])
    opts = (("iters", 4000), ("tol", 1e-11)) + (
        (("w_act", w_act),) if w_act else ())
    jargs = jadmm.from_onesided(*map(jnp.asarray, qp))
    jsol = jadmm.solve(*jargs, iters=4000, tol=1e-11)
    jgrads = jadmm._solve_bwd(opts, (*jargs, jsol), jnp.asarray(w))
    P, q, A, l, u = (t(a_)[None] for a_ in jargs)
    grads = admm._solve_bwd(opts, P, A, l, u, t(jsol.x)[None],
                            t(jsol.y)[None], t(w)[None])
    for name, got, g in zip("PqAlu", grads, jgrads):
        if w_act:
            close(got[0], g, rtol=1e-6, atol=1e-9, what=f"d{name}")
        else:
            g = np.asarray(g)
            err = np.abs(got[0].numpy() - g).max() / np.abs(g).max()
            assert err <= 1e-2, (name, err)


def test_solve_primal_gradient_matches_jax_vjp_and_fd():
    """The two-sided IFT adjoint through autograd: every cotangent against
    JAX's custom VJP on the same data and output weights, and d/dq, d/dh
    against central differences as tests/test_admm.py checks them.

    The reference's active-row penalty w_act = 0.01 / eps gives the
    reduced matrix a condition number ~1e14: float64 roundings in another
    order move the cotangents by up to ~4e-3 of their largest entry
    (measured on this QP from the same solution), and an active row's dl
    or du, W (A vx), moves in steps of ~8e-4 here (one ulp of A vx times
    W).  So the cotangents are held to 1e-2 of each one's max, and to
    central differences at rtol 1e-2 (the JAX package's VJP is 4.9e-3 from
    them on du[14], the port's 7.6e-3, one step further;
    tests/test_admm.py's bar is 5e-3)."""
    rng = np.random.default_rng(3)
    qp = random_qp(rng)
    w = rng.standard_normal(qp[1].shape[-1])
    opts = (("iters", 4000), ("tol", 1e-11))
    jargs = jadmm.from_onesided(*map(jnp.asarray, qp))
    _, vjp = jax.vjp(lambda *a: jadmm.solve_primal(*a, opts), *jargs)
    jgrads = vjp(jnp.asarray(w))
    pargs = [a.clone().requires_grad_(True) for a in
             admm.from_onesided(*(t(a)[None] for a in qp))]
    x = admm.solve_primal(*pargs, opts)
    torch.autograd.backward(x, t(w)[None])
    for name, a, g in zip("PqAlu", pargs, jgrads):
        g = np.asarray(g)
        err = np.abs(a.grad[0].numpy() - g).max() / np.abs(g).max()
        assert err <= 1e-2, (name, err)

    # central differences: the twelve perturbed QPs solved as one batch
    # (each scenario converges and freezes on its own)
    p = qp[3].shape[-1]
    P, q, A, l, u = (a.detach() for a in pargs)
    eps = 1e-5
    probes = [("q", 0), ("q", 7), ("q", 19), ("h", 0), ("h", 5), ("h", 14)]
    qs, us = [], []
    for which, idx in probes:
        for sign in (1.0, -1.0):
            qe, ue = q.clone(), u.clone()
            if which == "q":
                qe[0, idx] += sign * eps
            else:
                ue[0, p + idx] += sign * eps
            qs.append(qe)
            us.append(ue)
    k = len(qs)
    xs = admm.solve_primal(P.expand(k, -1, -1), torch.cat(qs),
                           A.expand(k, -1, -1), l.expand(k, -1),
                           torch.cat(us), opts)
    losses = (xs * t(w)).sum(-1).reshape(-1, 2)
    fd = (losses[:, 0] - losses[:, 1]) / (2 * eps)
    for (which, idx), d in zip(probes, fd.tolist()):
        got = (pargs[1].grad[0, idx] if which == "q"
               else pargs[4].grad[0, p + idx])
        np.testing.assert_allclose(float(got), d, rtol=1e-2, atol=1e-6,
                                   err_msg=f"d/d{which}[{idx}]")


def test_solve_step_on_admm_backend_matches_jax():
    """cfg.qp_backend="admm" (tests/test_admm.py's RTI: admm_iters=1600, the
    trot, the neutral warm start of make_state) no longer raises and gives
    the JAX package's step: the same stats and trajectory, and that test's
    bar (solved, qp_pri < 1e-3, finite)."""
    cfg = MPCConfig(qp_backend="admm", admm_iters=1600).validate()
    jmodel = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    jparams = jsrb.make_srb_params(jmodel, q0)
    x0 = jsrb.reconstruct_state(jparams, q0, jnp.zeros(jmodel.nv))
    feet0 = jrbd.ee_positions(jmodel, q0)
    traj = jdeft(cfg, jgait.make_trot(cfg), x0, feet0[:, :2])
    jst = jsolver.make_state(cfg, traj, jnp.asarray(cfg.ee_box_size,
                                                     jnp.float64))
    x_des = jsrb.manifold_to_tangent(x0)
    jst2, jstats = jax.jit(lambda s: jsolver.solve_step(
        cfg, jparams, s, x0, jnp.array(0.0), feet0, x_des,
        shift_window=False))(jst)

    pcfg = convert.from_config(cfg)
    st = convert.from_solver_state(jax.tree.map(lambda a: a[None], jst),
                                   device="cpu")
    st2, stats = solver.solve_step(
        pcfg, convert.from_srb_params(jparams, device="cpu"), st,
        t(x0)[None], torch.zeros(1, dtype=F64), t(feet0)[None],
        t(x_des)[None], shift_window=False)
    for f in ("cost", "merit", "defect_l1", "step_norm", "alpha", "qp_gap",
              "qp_pri", "qp_dua"):
        close(getattr(stats, f)[0], getattr(jstats, f), rtol=1e-6,
              atol=1e-8, what=f)
    for f in ("x_man", "f_nodes", "footholds"):
        close(getattr(st2.traj, f)[0], getattr(jst2.traj, f), rtol=1e-6,
              atol=1e-8, what=f)
    for f in ("x", "y", "lam", "s"):
        close(getattr(st2.qp_warm, f)[0], getattr(jst2.qp_warm, f),
              rtol=1e-6, atol=1e-8, what=f"warm {f}")
    assert int(st2.qp_warm.iters[0]) == int(jst2.qp_warm.iters)
    assert bool(stats.solved[0]) and bool(jstats.solved)
    assert float(stats.qp_pri[0]) < 1e-3
    assert np.all(np.isfinite(st2.traj.f_nodes.numpy()))
    assert isinstance(st2.qp_warm, pdip.QPSolution)


def test_float32_masked_row_is_nonfinite_as_in_jax():
    """A fault of the reference, reproduced: in float32 the Ruiz
    equilibration scales an all-zero (masked) equality row by 1e4 a sweep,
    1e40 after ten, past float32's range, so u d_c = 0 inf = NaN and the
    whole solution is non-finite, in the JAX package and in the port alike
    (the MPC QP has such rows: inactive touchdown pins and Raibert rows).
    In float64 the same QP solves."""
    H, q, A, b, G, h = random_qp(np.random.default_rng(6))
    A[-1] = 0.0
    b[-1] = 0.0
    for dtype, finite in ((np.float32, False), (np.float64, True)):
        qp = [a.astype(dtype) for a in (H, q, A, b, G, h)]
        ref = jadmm.solve_onesided(*map(jnp.asarray, qp), iters=200,
                                   tol=1e-6)
        got = admm.solve_onesided(*(torch.tensor(a)[None] for a in qp),
                                  iters=200, tol=1e-6)
        assert bool(np.isfinite(np.asarray(ref.x)).all()) == finite
        assert bool(torch.isfinite(got.x).all()) == finite
