"""One scenario's result does not depend on how many scenarios share its
batch (``sim/batch_invariance.py``, ``utils/jnp_compat.matvec``).

* ``engine.period`` run through a recording stage hook is the period run
  through the plain one, bit for bit (float32 and float64);
* every stage of the first two MPC ticks (tests/test_parallel.py:171-199's
  loop, its small configuration; the second tick's RTI warm-started) gives
  the first 4 scenarios the same bits at batch 4 and at batch 8, each stage
  of the batch-8 run fed the batch-4 run's inputs, in float32 and float64,
  the gait update too, and the last 4 scenarios on the first MPC tick; bit
  for bit, as the CPU gives it;
* the card's batch-invariant products that replaced ``M @ v[..., None]``
  (``jnp_compat.matvec`` / ``vecmat`` / ``matmul_nt`` on ``kernels.bmv``,
  at the shapes of their call sites, forced on CPU tensors, where the
  kernel's wrapper runs its plain version) and the functions rewritten on
  them (the assembly with its gradient through ``kernels._Bmv``'s
  autograd rules among them), against the old formulation in float64 at
  1e-12 of each result's largest magnitude; on CPU tensors the products
  keep the old bits;
* the tracing itself finds an operation that couples the scenarios;
* on the card (``cuda``-marked, skipped here): every stage of both MPC
  ticks but the IK's two bit for bit at batches 64 and 128, for either
  half of the 128 scenarios.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu_torch.control import wbqp
from bilevel_gait_gen_tpu_torch.models import rbd
from bilevel_gait_gen_tpu_torch.mpc import bilevel, qp as qp_mod
from bilevel_gait_gen_tpu_torch.mpc.gait import GaitSchedule
from bilevel_gait_gen_tpu_torch.ops import kernels, pdip
from bilevel_gait_gen_tpu_torch.sim import batch_invariance as bi
from bilevel_gait_gen_tpu_torch.sim import engine
from bilevel_gait_gen_tpu_torch.utils import jnp_compat as jc
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves

torch.set_num_threads(2)

SMALL, LARGE = 4, 8
STAGES = ("ee_positions", "latch_contact", "srb_state", "rti", "targets",
          "ik", "feet_motion", "base_velocity", "ik_velocities", "wbqp",
          "physics_1", "physics_2", "physics_3", "physics_4")
# the stages whose product stays cuBLAS's batched GEMV (control/ik.py)
CUBLAS_STAGES = ("ik", "ik_velocities")
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def start(batch, device, dtype):
    case, st, q0, v0, xd = bi.loop_case(batch, device, dtype)
    return case, engine.initial_state(case.model, case.cfg, case.sim, st,
                                      q0, v0), xd


@pytest.fixture(scope="module", params=list(DTYPES))
def stage_diffs(request):
    """{MPC tick: {stage: StageDiff}}: the first MPC tick (cold solver
    state, and the gait update on the same inputs) and the second (the RTI
    warm-started, after two control ticks), the first 4 scenarios; "last":
    the first MPC tick, the last 4."""
    case, st, q0, v0, xd = bi.loop_case(LARGE, "cpu", DTYPES[request.param])
    _, _, starts = bi.instrumented_loop(case, st, q0, v0, xd, n_ticks=4,
                                        mpc_every=3)
    out = {}
    for k, ls in enumerate(starts):
        out[k] = {d.name: d for d in bi.compare_stages(case, ls, xd,
                                                       SMALL)[0]}
    out[0].update({d.name: d for d in bi.compare_stages(
        case, starts[0], xd, SMALL, gait=True)[0]
        if d.name == "gait_opt_update"})
    out["last"] = {d.name: d for d in bi.compare_stages(
        case, starts[0], xd, SMALL, lo=LARGE - SMALL)[0]}
    return out


@pytest.mark.parametrize("stage", STAGES + ("gait_opt_update",))
def test_first_mpc_tick_stage_bit_for_bit_at_both_batches(stage_diffs,
                                                         stage):
    d = stage_diffs[0][stage]
    assert d.bitwise, (stage, d.per_output)


@pytest.mark.parametrize("stage", STAGES)
def test_second_mpc_tick_stage_bit_for_bit_at_both_batches(stage_diffs,
                                                          stage):
    d = stage_diffs[1][stage]
    assert d.bitwise, (stage, d.per_output)


@pytest.mark.parametrize("stage", STAGES)
def test_last_scenarios_stage_bit_for_bit_at_both_batches(stage_diffs,
                                                          stage):
    d = stage_diffs["last"][stage]
    assert d.bitwise, (stage, d.per_output)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stage_hook_keeps_the_period_bit_for_bit(dtype):
    """``engine.period`` through a recording hook, over an MPC tick and a
    control tick, is the period through the plain hook; the hook sees every
    stage in order, and the torque QP's sweeps."""
    case, ls, xd = start(LARGE, "cpu", DTYPES[dtype])
    want = engine.period(case.model, case.params, case.cfg, case.wb_cfg,
                         case.sim, xd, ls, control_dt=case.control_dt,
                         ticks=2, gait=False, contact_sync=False)
    rec = bi.Recorder()
    got = case.period(ls, xd, ticks=2, call=rec)
    assert all(bi.same_bits(a, b) for a, b in zip(
        tree_leaves(got), tree_leaves(want)))
    assert tuple(rec.outs) == STAGES
    tau, iters = rec.outs["wbqp"]
    assert bi.same_bits(tau, want[1].tau[1])
    assert iters.shape == (LARGE,) and bool((iters >= 1).all())
    assert bool((iters <= case.wb_cfg.ipm_iters).all())


def test_instrumented_loop_is_the_closed_loop():
    case, st, q0, v0, xd = bi.loop_case(2, "cpu", torch.float64)
    _, ref = engine.closed_loop(case.model, case.params, case.cfg,
                                case.wb_cfg, case.sim, st, q0, v0, xd,
                                n_ticks=5, control_dt=case.control_dt,
                                mpc_every=3)
    log, ch, starts = bi.instrumented_loop(case, st, q0, v0, xd, n_ticks=5,
                                           mpc_every=3)
    assert [int(s.tick) for s in starts] == [0, 3]
    assert all(bi.same_bits(a, b) for a, b in zip(log, ref))
    assert ch.qp_iters.shape == (5, 2) and ch.mc.shape == (5, 2, 4)
    assert bool(torch.isnan(ch.alpha[1]).all())          # no MPC on tick 1
    assert not bi.flips(ch, ch, 0, 4)


def test_tracing_finds_an_operation_that_couples_the_scenarios():
    def fn(x, w):
        y = x * 2.0
        return ((y - y.mean(0, keepdim=True)) @ w).sum(-1)
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 5, generator=gen), torch.randn(5, 3, generator=gen)
    found, n_ops, parted, calls = bi.origin_ops(fn, (x[:4], w), (x, w))
    assert parted is None and n_ops > 3
    assert [o.op for o in found] == ["mean.dim"] and list(calls) == [
        found[0].index]
    assert bi.kernel_names({"mean": calls[found[0].index][1]}) == {
        "mean": []}                                  # no device on the CPU


def old_matvec(M, v):
    return (M @ v[..., None])[..., 0]


def old_vecmat(v, M):
    return (v[..., None, :] @ M)[..., 0, :]


def assert_close(new, old, rtol=1e-12):
    new, old = np.asarray(new), np.asarray(old)
    assert new.shape == old.shape
    scale = max(np.abs(old).max(), 1e-300)
    np.testing.assert_allclose(new, old, rtol=0, atol=rtol * scale)


def card_rule(M):
    """``jnp_compat``'s choice of form as on the card, for CPU tensors."""
    return M.shape[-1] <= jc.MATVEC_SUM_WIDTH


@pytest.fixture
def card_form(monkeypatch):
    """The card's products (``kernels.bmv``, on CPU tensors its plain
    version) on CPU tensors; the list of the calls' operand shapes."""
    calls = []
    bmv = kernels.bmv

    def counted(X, Y):
        calls.append((tuple(X.shape), tuple(Y.shape)))
        return bmv(X, Y)
    monkeypatch.setattr(jc, "_summed", card_rule)
    monkeypatch.setattr(kernels, "bmv", counted)
    return calls


# (M shape, v shape) of the call sites: the RTI's and the torque QP's
# products, the IK's, the physics' contact forces and link inertias, the
# broadcast of one vector over a batch of matrices, a tall matrix (Adam's
# inequality rows), and a matrix wider than MATVEC_SUM_WIDTH (the GEMV
# kept)
MATVEC_SHAPES = [((8, 120, 120), (8, 120)), ((8, 288, 120), (8, 120)),
                 ((8, 44, 30), (8, 30)), ((8, 4, 3, 18), (8, 1, 18)),
                 ((8, 13, 3, 3), (8, 13, 3)), ((8, 84, 120), (8, 120)),
                 ((8, 3, 3), (3,)), ((2, 640, 128), (2, 128)),
                 ((2, 16, 232), (2, 232))]


@pytest.mark.parametrize("shapes", MATVEC_SHAPES,
                         ids=lambda s: "x".join(map(str, s[0])))
def test_card_products_are_the_old_products(card_form, shapes):
    gen = torch.Generator().manual_seed(1)
    ms, vs = shapes
    M = torch.randn(*ms, dtype=torch.float64, generator=gen)
    v = torch.randn(*vs, dtype=torch.float64, generator=gen)
    assert_close(jc.matvec(M, v), old_matvec(M, v))
    w = torch.randn(*ms[:-1], dtype=torch.float64, generator=gen)
    assert_close(jc.vecmat(w, M), old_vecmat(w, M))
    # with M^T made once, as an interior-point solve makes it
    assert_close(jc.vecmat(w, M, jc.transposed(M)), old_vecmat(w, M))
    # a transposed view goes through the same form
    assert_close(jc.matvec(M.mT, w), old_matvec(M.mT, w))
    X = torch.randn(*ms[:-2], 16, ms[-1], dtype=torch.float64, generator=gen)
    assert_close(jc.matmul_nt(X, M), X @ M.mT)
    kept = ms[-1] > jc.MATVEC_SUM_WIDTH
    assert bi.same_bits(jc.matvec(M, v), old_matvec(M, v)) or not kept
    assert (jc.transposed(M) is None) == kept
    # the card's form is the kernel's: each product above of a matrix of at
    # most MATVEC_SUM_WIDTH columns was one kernels.bmv call (five on M, one
    # on M's transposed view)
    wide_t = ms[-2] > jc.MATVEC_SUM_WIDTH
    assert len(card_form) == 5 * (not kept) + (not wide_t)


def test_cpu_products_keep_their_bits():
    """On CPU tensors the products are the old ones, bit for bit."""
    gen = torch.Generator().manual_seed(2)
    M = torch.randn(8, 44, 30, generator=gen)
    v, w = torch.randn(8, 30, generator=gen), torch.randn(8, 44,
                                                         generator=gen)
    assert jc.transposed(M) is None
    assert bi.same_bits(jc.matvec(M, v), old_matvec(M, v))
    assert bi.same_bits(jc.vecmat(w, M), old_vecmat(w, M))
    assert bi.same_bits(jc.matmul_nt(M, M), M @ M.mT)


@pytest.fixture(scope="module")
def f64_state():
    case, ls, xd = start(LARGE, "cpu", torch.float64)
    rec = bi.Recorder()
    case.period(ls, xd, ticks=1, call=rec)
    return case, rec


def card_and_cpu(monkeypatch, fn, *args):
    """(fn(*args) with the card's products, with the CPU's)."""
    with monkeypatch.context() as m:
        m.setattr(jc, "_summed", card_rule)
        card = fn(*args)
    return card, fn(*args)


def test_rewritten_dynamics_are_the_old_formulation(f64_state, monkeypatch):
    case, rec = f64_state
    q, v, tau = rec.args["physics_1"]
    for a, b in zip(*card_and_cpu(monkeypatch, rbd.dynamics_terms,
                                  case.model, q, v)):
        assert_close(a, b)
    for a, b in zip(*card_and_cpu(monkeypatch, engine.physics_step,
                                  case.model, case.sim, q, v, tau, 1e-3)):
        assert_close(a, b)


def test_rewritten_controller_and_states_are_the_old_formulation(
        f64_state, monkeypatch):
    case, rec = f64_state
    for a, b in zip(*card_and_cpu(monkeypatch, rec.fns["base_velocity"],
                                  *rec.args["base_velocity"])):
        assert_close(a, b)
    assert_close(*card_and_cpu(monkeypatch, rec.fns["srb_state"],
                               *rec.args["srb_state"]))
    st, x_srb, t, feet, xd = rec.args["rti"]
    qp = qp_mod.assemble(case.cfg, case.params, st.traj, x_srb, t, feet, xd,
                         st.ee_box)
    u = torch.linspace(-1.0, 1.0, qp.q.shape[-1],
                       dtype=torch.float64).expand_as(qp.q)
    assert_close(*card_and_cpu(monkeypatch, qp_mod.recover_states, qp, u))
    # the interior-point sweep's products: the residuals of one iterate
    x0 = torch.full_like(qp.q, 0.1)
    y0, lam = torch.ones_like(qp.b), torch.ones_like(qp.h)
    for a, b in zip(*card_and_cpu(monkeypatch, pdip._residuals, qp.H, qp.q,
                                  qp.A, qp.b, qp.G, qp.h, x0, y0, lam, lam)):
        assert_close(a, b)


def test_assembly_and_its_gradient_are_the_old_formulation(f64_state,
                                                           monkeypatch):
    """``qp.assemble`` (``srb.linearize``: ``jacfwd`` under ``vmap`` of
    ``srb._mv``'s shared inertia) and the gradient of the QP objectives
    with respect to the contact times through it (the outer gradient's
    reverse mode, ``mpc/bilevel.py``), on the card's products
    (``kernels._Bmv``'s rules) against the CPU's."""
    case, rec = f64_state
    st, x_srb, t, feet, xd = rec.args["rti"]

    def assembled():
        bounds = st.traj.sched.bounds.detach().clone().requires_grad_(True)
        traj = dataclasses.replace(st.traj,
                                   sched=GaitSchedule(bounds=bounds))
        with torch.enable_grad():
            qp = qp_mod.assemble(case.cfg, case.params, traj, x_srb, t, feet,
                                 xd, st.ee_box)
            u = torch.linspace(-1.0, 1.0, qp.q.shape[-1],
                               dtype=torch.float64).expand_as(qp.q)
            (g,) = torch.autograd.grad(bilevel.qp_objective(qp, u).sum(),
                                       bounds)
        return qp.H.detach(), qp.q.detach(), qp.A.detach(), qp.G.detach(), g
    card, cpu = card_and_cpu(monkeypatch, assembled)
    assert bool(card[-1].abs().max() > 0)
    for a, b in zip(card, cpu):
        assert_close(a, b)


def test_rewritten_torque_qp_rows_are_the_old_formulation(f64_state,
                                                          monkeypatch):
    """The torque QP with one sweep, so that the interior-point solve does
    not amplify the last bits."""
    case, rec = f64_state
    cfg = wbqp.WBQPConfig(ipm_iters=1)

    def one_sweep(*a):
        return wbqp.compute_torques(case.model, cfg, *a)
    assert_close(*card_and_cpu(monkeypatch, one_sweep, *rec.args["wbqp"]))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the batch's kernels are the card's)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_stage_bit_for_bit_at_64_and_128_on_the_card(card):
    """All but the IK's two (its product stays cuBLAS's, PERF.md), for
    either half of the 128 scenarios."""
    case, st, q0, v0, xd = bi.loop_case(128, card, torch.float32)
    _, _, starts = bi.instrumented_loop(case, st, q0, v0, xd,
                                        n_ticks=bi.LOOP["n_ticks"],
                                        mpc_every=bi.LOOP["mpc_every"])
    for k, ls in enumerate(starts):
        for lo, gait in (((0, False), (0, True), (64, False)) if k == 0
                         else ((0, False), (64, False))):
            diffs, _, _ = bi.compare_stages(case, ls, xd, 64, lo=lo,
                                            gait=gait)
            assert all(d.bitwise for d in diffs
                       if d.name not in CUBLAS_STAGES), [
                (k, lo, d.name, d.max_diff) for d in diffs if not d.bitwise]
