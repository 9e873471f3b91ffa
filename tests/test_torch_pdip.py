"""Port parity of the interior-point solver (ops/pdip.py) against the JAX
package: the unrolled sweep path in float64, the IFT adjoint, and the fused
sweep path (kernels.ipm_iter's plain version on CPU tensors) against the
Pallas kernel in interpret mode in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.ops import pallas_kernels as pk
from bilevel_gait_gen_tpu.ops import pdip as jpdip
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.ops import pdip

torch.set_num_threads(2)


def _random_qp(seed, n=40, m=60, p=12, dtype=np.float64, masked=False):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    H = L @ L.T + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((p, n))
    b = rng.standard_normal(p)
    G = rng.standard_normal((m, n))
    h = rng.standard_normal(m) + 2.0
    if masked:                      # masked-row conventions
        G[[3, 17]] = 0.0
        h[[3, 17]] = 1.0
        A[5] = 0.0
        b[5] = 0.0
    return [x.astype(dtype) for x in (H, q, A, b, G, h)]


def _batch(qps):
    return [torch.tensor(np.stack([qp[i] for qp in qps])) for i in range(6)]


def _jax_solves(qps, **kw):
    return [jpdip.solve(*map(jnp.asarray, qp), **kw) for qp in qps]


FIELDS = ("x", "y", "lam", "s", "gap", "pri_res", "dua_res")


def _compare(sol, jsols, rtol, atol, fields=FIELDS):
    """Per field, the port's batch against the JAX solves one by one."""
    for k, js in enumerate(jsols):
        for f in fields:
            np.testing.assert_allclose(
                getattr(sol, f)[k].numpy(), np.asarray(getattr(js, f)),
                rtol=rtol, atol=atol, err_msg=f"{f}[{k}]")
        assert int(sol.iters[k]) == int(js.iters)


# float64 unrolled path: both sides run the same sweeps with the same
# exact/Newton-Schulz cadence; measured agreement is ~1e-12, so rtol 1e-6
# with a 1e-9 floor on near-zero entries (duals of inactive rows) leaves
# wide margin while catching any change of algorithm.
RTOL64, ATOL64 = 1e-6, 1e-9


@pytest.mark.parametrize("kw", [
    dict(iters=20, tol=1e-9),
    dict(iters=8, exact_every=3),
    dict(iters=10, exact_every=2, refine_steps=2),
], ids=["cold", "ns_cadence", "refine2"])
def test_solve_matches_jax_cold(kw):
    qps = [_random_qp(0), _random_qp(1, masked=True)]
    _compare(pdip.solve(*_batch(qps), **kw), _jax_solves(qps, **kw),
             RTOL64, ATOL64)


def test_solve_warm_and_fast_path_match_jax():
    qps = [_random_qp(2), _random_qp(3, masked=True)]
    args = _batch(qps)
    cold = pdip.solve(*args, iters=20)
    jcold = _jax_solves(qps, iters=20)
    for it, ee in ((8, 3), (0, 1)):           # warm sweeps, iters=0 fast path
        sol = pdip.solve(*args, iters=it, exact_every=ee, warm=cold)
        jsols = [jpdip.solve(*map(jnp.asarray, qp), iters=it, exact_every=ee,
                             warm=jc) for qp, jc in zip(qps, jcold)]
        _compare(sol, jsols, RTOL64, ATOL64)


def test_sentinel_warm_start_falls_back_and_fast_path_reports_inf():
    """gap = inf marks a never-solved warm start: the sweeps restart from
    the Mehrotra point, and the iters=0 fast path surfaces inf residuals
    instead of a solution (pdip.py:406-416, 435-464)."""
    qps = [_random_qp(4), _random_qp(5)]
    args = _batch(qps)
    B, n, m, p = 2, 40, 60, 12
    z = torch.zeros
    sentinel = pdip.QPSolution(
        x=z(B, n, dtype=torch.float64), y=z(B, p, dtype=torch.float64),
        lam=torch.ones(B, m, dtype=torch.float64),
        s=torch.ones(B, m, dtype=torch.float64),
        iters=z(B, dtype=torch.int32),
        gap=torch.tensor([float("inf"), float("inf")], dtype=torch.float64),
        pri_res=torch.ones(B, dtype=torch.float64),
        dua_res=torch.ones(B, dtype=torch.float64))
    jsent = [jpdip.QPSolution(*(np.asarray(getattr(sentinel, f.name))[k]
                                for f in dataclasses.fields(sentinel)))
             for k in range(B)]
    sol = pdip.solve(*args, iters=10, warm=sentinel)
    jsols = [jpdip.solve(*map(jnp.asarray, qp), iters=10, warm=js)
             for qp, js in zip(qps, jsent)]
    _compare(sol, jsols, RTOL64, ATOL64)
    cold = pdip.solve(*args, iters=10)
    np.testing.assert_array_equal(sol.x.numpy(), cold.x.numpy())

    fast = pdip.solve(*args, iters=0, warm=sentinel)
    assert torch.isinf(fast.gap).all() and torch.isinf(fast.pri_res).all()
    assert torch.isinf(fast.dua_res).all()
    jfast = jpdip.solve(*map(jnp.asarray, qps[0]), iters=0, warm=jsent[0])
    assert np.isinf(float(jfast.gap))


def _vjp_pair(qps, opts, gx, warms=None, jwarms=None):
    """(port gradients [6][B, ...], JAX gradients per problem)."""
    args = [a.clone().requires_grad_(True) for a in _batch(qps)]
    x = pdip.solve_primal(*args, opts, warms)
    grads = torch.autograd.grad((x * torch.tensor(gx)).sum(), args)
    jgrads = []
    for k, qp in enumerate(qps):
        jw = None if jwarms is None else jwarms[k]
        _, vjp = jax.vjp(lambda *a: jpdip.solve_primal(*a, opts, jw),
                         *map(jnp.asarray, qp))
        jgrads.append(vjp(jnp.asarray(gx[k]))[:6])
    return grads, jgrads


def test_solve_primal_backward_matches_jax_vjp_at_same_point():
    """The IFT adjoint (_bwd_impl) against JAX's custom VJP at the same
    solution (the JAX one, converted; iters=0 keeps it as is), float64:
    rtol 1e-6 (measured ~1e-13)."""
    qps = [_random_qp(6), _random_qp(7, masked=True)]
    jsols = _jax_solves(qps, iters=20, tol=1e-10)
    warm = convert.from_qp_solution(
        jax.tree.map(lambda *a: jnp.stack(a), *jsols), device="cpu")
    gx = np.random.default_rng(8).standard_normal((2, 40))
    grads, jgrads = _vjp_pair(qps, (("iters", 0),), gx, warm, jsols)
    for k in range(2):
        for name, g, gj in zip("HqAbGh", grads, jgrads[k]):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(gj),
                                       rtol=1e-6, atol=1e-9, err_msg=name)


def test_solve_primal_gradient_end_to_end_matches_jax():
    """Forward sweeps and adjoint together.  At a converged point the
    adjoint's matrix carries W = lam / s up to 1e13 on active rows, so the
    forward solves' last-digit differences (~1e-12 in x) move the gradient
    by ~1e-4 of its largest entry (measured 2e-4); hold it to 1e-3 of the
    largest entry."""
    qps = [_random_qp(6), _random_qp(7, masked=True)]
    gx = np.random.default_rng(8).standard_normal((2, 40))
    grads, jgrads = _vjp_pair(qps, (("iters", 12), ("tol", 1e-9)), gx)
    for k in range(2):
        for name, g, gj in zip("HqAbGh", grads, jgrads[k]):
            gj = np.asarray(gj)
            err = np.abs(g[k].numpy() - gj).max() / np.abs(gj).max()
            assert err < 1e-3, (name, k, err)


def test_chol_inverse_fills_nan_for_indefinite_problems_only():
    """torch.linalg.cholesky would raise; the port marks the failed problem
    NaN, as jnp.linalg.cholesky does, and keeps the rest of the batch."""
    good = np.eye(4) * 2.0
    bad = np.diag([1.0, -1.0, 1.0, 1.0])
    X = pdip._chol_inverse(torch.tensor(np.stack([good, bad])))
    np.testing.assert_allclose(X[0].numpy(), np.eye(4) / 2.0)
    assert torch.isnan(X[1]).all()
    jX = jpdip._chol_inverse(jnp.asarray(bad))
    assert np.isnan(np.asarray(jX)).all()


def test_use_pallas_auto_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert pdip._use_pallas_auto(torch.float32, 232, cuda)
    assert not pdip._use_pallas_auto(torch.float32, 36, cuda)
    assert not pdip._use_pallas_auto(torch.float64, 232, cuda)
    assert not pdip._use_pallas_auto(torch.float32, 232, cpu)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)


# float32 fused path vs the Pallas kernel in interpret mode: the two run the
# same sweep math in a different reduction order, so f32 rounding moves the
# iterates; rtol 1e-3 / atol 1e-4 is the bound tests/test_pallas_kernels.py
# holds the Pallas kernel to against the XLA path.
RTOL32, ATOL32 = 1e-3, 1e-4


def test_fused_path_matches_pallas_interpret(interpret_mode):
    qps = [_random_qp(0, dtype=np.float32), _random_qp(1, dtype=np.float32)]
    sol = pdip.solve(*_batch(qps), iters=20, tol=1e-7, use_pallas=True)
    jsols = _jax_solves(qps, iters=20, tol=1e-7, use_pallas=True)
    for k, js in enumerate(jsols):
        assert float(sol.gap[k]) < 1e-5 and float(sol.pri_res[k]) < 1e-4
        np.testing.assert_allclose(sol.x[k].numpy(), np.asarray(js.x),
                                   rtol=RTOL32, atol=ATOL32)


def test_fused_path_warm_ns_matches_pallas_interpret(interpret_mode):
    qps = [_random_qp(1, dtype=np.float32)]
    args = _batch(qps)
    cold = pdip.solve(*args, iters=20, tol=1e-7, use_pallas=True)
    warm = pdip.solve(*args, iters=8, tol=1e-7, exact_every=3,
                      use_pallas=True, warm=cold)
    jcold = _jax_solves(qps, iters=20, tol=1e-7, use_pallas=True)[0]
    jwarm = jpdip.solve(*map(jnp.asarray, qps[0]), iters=8, tol=1e-7,
                        exact_every=3, use_pallas=True, warm=jcold)
    assert float(warm.gap[0]) < 1e-5
    np.testing.assert_allclose(warm.x[0].numpy(), np.asarray(jwarm.x),
                               rtol=RTOL32, atol=ATOL32)
    np.testing.assert_allclose(warm.x[0].numpy(), cold.x[0].numpy(),
                               rtol=RTOL32, atol=ATOL32)
    assert convert.to_numpy(warm.iters).dtype == np.int32


def test_fused_lane_cadence_stalls_on_ns_sweeps_like_pallas(interpret_mode):
    """A cold lane solve of an A1 QP (ls cadence: exact sweeps 0-1, NS after)
    through the fused path: the Newton-Schulz refresh from the cold start
    diverges, and without the XLA path's non-finite fallback every NS sweep
    rejects its step.  The port reproduces the Pallas kernel here: both
    sides end where the two exact sweeps left them (the fault recorded in
    ROADMAP.md section 3).  float32; after two cold sweeps the iterate's
    weakly determined directions differ by rounding between the two sides
    (measured 2.7e-2 on single entries of x), so the sides are compared on
    the residuals they report, to 1e-3."""
    from bilevel_gait_gen_tpu.utils.config import MPCConfig
    from bilevel_gait_gen_tpu_torch.mpc import qp as qp_mod, solver
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    cfg = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                    samples_per_stance=4, ee_node_start=1, ipm_iters=10,
                    max_ls_iters=4, dt=0.05).validate()
    pr = make_problem(cfg, 1, dtype=torch.float32, device="cpu")
    st, _ = solver.solve_step(cfg, pr.params, pr.states, pr.x0s, pr.t0,
                              pr.feets, pr.x_des)
    qp = qp_mod.assemble(cfg, pr.params, st.traj, pr.x0s, pr.t0, pr.feets,
                         pr.x_des, st.ee_box)
    args = [getattr(qp, f) for f in ("H", "q", "A", "b", "G", "h")]
    jargs = [jnp.asarray(a[0].numpy()) for a in args]
    kw = dict(tol=1e-9, exact_every=5, use_pallas=True)
    two = pdip.solve(*args, iters=2, **kw)
    four = pdip.solve(*args, iters=4, **kw)
    jtwo = jpdip.solve(*jargs, iters=2, **kw)
    jfour = jpdip.solve(*jargs, iters=4, **kw)
    np.testing.assert_array_equal(four.x.numpy(), two.x.numpy())
    np.testing.assert_array_equal(np.asarray(jfour.x), np.asarray(jtwo.x))
    for f in ("gap", "pri_res"):
        np.testing.assert_allclose(float(getattr(four, f)[0]),
                                   float(getattr(jfour, f)), rtol=1e-3,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# inverse="gj" and "schur".  The JAX "gj" runs its Pallas kernel only with
# pk.INTERPRET set (off the TPU it otherwise silently runs the Cholesky, and
# the comparison would be vacuous); on CPU tensors the port runs the
# kernel's plain version at the same block width.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(iters=12, tol=1e-9),
    dict(iters=8, exact_every=3),
], ids=["every_sweep_exact", "ns_cadence"])
@pytest.mark.parametrize("inverse", ["gj", "schur"])
def test_solve_with_shifted_inverses_matches_jax(interpret_mode, inverse, kw):
    """float64, unrolled path: start point and every exact refresh through
    the named inverse on both sides.  Both deflate a 1e-3 shift with
    Newton-Schulz steps down to ~1e-13 residuals, so the sweeps agree as
    they do under the Cholesky: rtol 1e-6, atol 1e-9.  Against the
    Cholesky solve itself only to 1e-3: on the last sweeps W = lam / s
    spans more decades than ten deflation steps can take the shift out
    of."""
    qps = [_random_qp(12), _random_qp(13, masked=True)]
    sol = pdip.solve(*_batch(qps), inverse=inverse, **kw)
    _compare(sol, _jax_solves(qps, inverse=inverse, **kw), RTOL64, ATOL64)
    chol = pdip.solve(*_batch(qps), **kw)
    np.testing.assert_allclose(sol.x.numpy(), chol.x.numpy(), rtol=0,
                               atol=1e-3)


def test_gj_solve_reaches_the_gj_kernel_wrapper(monkeypatch):
    """Which inverses go through kernels.spd_inverse: the start point and
    every exact refresh of the unrolled path (sweeps 0, 1 and 5 of ten at
    exact_every=5), the start point alone on the fused path (its exact
    refresh is the Cholesky whatever ``inverse`` says, as in the JAX
    package), and none under "chol"."""
    from bilevel_gait_gen_tpu_torch.ops import kernels
    calls = []
    spd = kernels.spd_inverse
    monkeypatch.setattr(kernels, "spd_inverse",
                        lambda M, **k: calls.append(M.shape) or spd(M, **k))
    args = _batch([_random_qp(14, dtype=np.float32)])
    pdip.solve(*args, iters=10, tol=0.0, exact_every=5, inverse="gj",
               use_pallas=False)
    assert len(calls) == 4
    calls.clear()
    pdip.solve(*args, iters=4, tol=0.0, exact_every=5, inverse="gj",
               use_pallas=True)
    assert [tuple(c) for c in calls] == [(1, 128, 128)]
    calls.clear()
    pdip.solve(*args, iters=4, tol=0.0, exact_every=5, use_pallas=False)
    assert calls == []


def test_fused_path_with_gj_start_matches_pallas_interpret(interpret_mode):
    """float32 fused path under inverse="gj" (the Gauss-Jordan start point,
    Cholesky exact refreshes) against the JAX package in interpret mode, at
    the fused path's own tolerance."""
    qps = [_random_qp(0, dtype=np.float32), _random_qp(1, dtype=np.float32)]
    sol = pdip.solve(*_batch(qps), iters=20, tol=1e-7, use_pallas=True,
                     inverse="gj")
    jsols = _jax_solves(qps, iters=20, tol=1e-7, use_pallas=True,
                        inverse="gj")
    for k, js in enumerate(jsols):
        assert float(sol.gap[k]) < 1e-5 and float(sol.pri_res[k]) < 1e-4
        np.testing.assert_allclose(sol.x[k].numpy(), np.asarray(js.x),
                                   rtol=RTOL32, atol=ATOL32)


def test_gj_adjoint_matches_jax_grad(interpret_mode):
    """The IFT adjoint with its matrix inverted by the Gauss-Jordan path,
    float64.  At the same solution (iters=0) against JAX's custom VJP: rtol
    1e-6, as under the Cholesky; end to end (12 sweeps under "gj", then the
    adjoint) against jax.grad of the same scalar: 1e-3 of the largest
    entry, the bound of the Cholesky end-to-end test above."""
    qps = [_random_qp(6), _random_qp(7, masked=True)]
    gx = np.random.default_rng(8).standard_normal((2, 40))
    jsols = _jax_solves(qps, iters=20, tol=1e-10)
    warm = convert.from_qp_solution(
        jax.tree.map(lambda *a: jnp.stack(a), *jsols), device="cpu")
    opts = (("iters", 0), ("inverse", "gj"))
    grads, jgrads = _vjp_pair(qps, opts, gx, warm, jsols)
    for k in range(2):
        for name, g, gj in zip("HqAbGh", grads, jgrads[k]):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(gj),
                                       rtol=1e-6, atol=1e-9, err_msg=name)
    opts = (("iters", 12), ("tol", 1e-9), ("inverse", "gj"))
    args = [a.clone().requires_grad_(True) for a in _batch(qps)]
    x = pdip.solve_primal(*args, opts, None)
    grads = torch.autograd.grad((x * torch.tensor(gx)).sum(), args)
    for k, qp in enumerate(qps):
        jg = jax.grad(lambda *a: jnp.sum(jpdip.solve_primal(*a, opts, None)
                                         * jnp.asarray(gx[k])),
                      argnums=tuple(range(6)))(*map(jnp.asarray, qp))
        for name, g, gj in zip("HqAbGh", grads, jg):
            gj = np.asarray(gj)
            err = np.abs(g[k].numpy() - gj).max() / np.abs(gj).max()
            assert err < 1e-3, (name, k, err)


# ---------------------------------------------------------------------------
# The fused path forms M once per sweep: an exact sweep hands the M of its
# Cholesky refresh on to kernels.ipm_iter.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(iters=8, exact_every=3),
    dict(iters=4, exact_every=5),
], ids=["rti_cadence", "lane_cadence"])
def test_fused_path_hands_M_on_exact_sweeps_only(monkeypatch, kw):
    """kernels.gtwg is called once per exact sweep by the solver and its
    result, the same tensor, is what kernels.ipm_iter gets as ``M``; a
    Newton-Schulz sweep hands none (the sweep forms its own).  The solve
    returns, bit for bit, what it returns when every sweep forms its own
    M (float32, CPU tensors: both ways run the same plain arithmetic)."""
    from bilevel_gait_gen_tpu_torch.ops import kernels
    args = _batch([_random_qp(20, dtype=np.float32),
                   _random_qp(21, dtype=np.float32, masked=True)])
    formed, handed = [], []
    gtwg, ipm_iter = kernels.gtwg, kernels.ipm_iter

    def rec_gtwg(*a, **k):
        formed.append(gtwg(*a, **k))
        return formed[-1]

    def rec_iter(*a, M=None, **k):
        handed.append((bool(a[15]), M))
        return ipm_iter(*a, M=M, **k)

    monkeypatch.setattr(kernels, "gtwg", rec_gtwg)
    monkeypatch.setattr(kernels, "ipm_iter", rec_iter)
    sol = pdip.solve(*args, tol=1e-7, use_pallas=True, **kw)
    exact = [i < 2 or i % kw["exact_every"] == 0 for i in range(kw["iters"])]
    assert [not ns for ns, _ in handed] == exact
    assert len(formed) == sum(exact)
    mats = iter(formed)
    for ns, M in handed:
        assert (M is None) if ns else (M is next(mats))

    monkeypatch.setattr(kernels, "ipm_iter",
                        lambda *a, M=None, **k: ipm_iter(*a, **k))
    own = pdip.solve(*args, tol=1e-7, use_pallas=True, **kw)
    for f in FIELDS + ("iters",):
        assert torch.equal(getattr(sol, f), getattr(own, f)), f


def test_fused_path_handing_M_keeps_the_jax_signature():
    """With M left out, kernels.ipm_iter and its plain version take the
    arguments of pallas_kernels.ipm_iter in the same order and the same
    keywords; ``M`` is the port's one addition, keyword only, default None."""
    import inspect
    from bilevel_gait_gen_tpu_torch.ops import kernels
    jparams = list(inspect.signature(pk.ipm_iter).parameters)
    for fn in (kernels.ipm_iter, kernels.ipm_iter_reference):
        params = inspect.signature(fn).parameters
        names = [n for n in params if n != "M"]
        assert names == [n for n in jparams if n != "interpret"], names
        assert params["M"].default is None
        assert params["M"].kind is inspect.Parameter.KEYWORD_ONLY
