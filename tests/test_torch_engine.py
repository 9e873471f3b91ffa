"""The port's on-device closed loop (``sim/engine.py``) against the JAX
package, float64, and its structure.

* contact_forces, physics_step (free fall; standing on the ground) and
  settled_stand against the JAX functions: 1e-10 of each result's largest
  magnitude (the same formulas; the port's dynamics are closed forms of the
  JAX package's autodiff, ~1e-15 apart);
* a 30-tick standing rollout of ``closed_loop`` (the configuration of
  tests/test_sim_engine.py::test_closed_loop_standing_small), batch 2 on
  the port's side against ``jax.jit(closed_loop)`` on each scenario
  (``torch_jax_common.jit_per_scenario``, vmap's result): every log
  field at every tick within 1e-6 of the field's largest magnitude over the
  rollout.  Measured ~1e-10: the IPM solves (the MPC's and the torque
  QP's, conditioned up to ~1e8) amplify float64 rounding, and 30 ticks of
  feedback carry it on; the bound keeps four decades for that and still
  sees any error of formulation, which moves a rollout at 1e-3 or more;
* the period loop equal to a plain loop over ticks bit for bit (with a
  partial last period and the gait update on); the batch of 2 equal to two
  batches of 1 at the JAX comparison's tolerance (the batched matrix
  products sum in a batch-size dependent order);
* the host-copy guard over the per-tick entry points;
* on the card (``cuda``-marked, skipped here): a replayed period equals
  the eager one bit for bit, and so does a graphed loop whose last period
  is partial.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.control import wbqp as jwbqp
from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait, solver as jsolver
from bilevel_gait_gen_tpu.mpc.gait import GaitSchedule as JSched
from bilevel_gait_gen_tpu.mpc.trajectory import (Trajectory as JTraj,
                                                 default_trajectory as jdeft)
from bilevel_gait_gen_tpu.sim import engine as jengine
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.control import mpc_controller
from bilevel_gait_gen_tpu_torch.models import a1, rbd
from bilevel_gait_gen_tpu_torch.mpc import solver
from bilevel_gait_gen_tpu_torch.sim import engine
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves, tree_map
from test_torch_cadence import assert_bitwise, no_host_data  # noqa: F401
from torch_jax_common import jit_per_scenario

torch.set_num_threads(2)

F64 = torch.float64
B = 2
# tests/test_sim_engine.py::test_closed_loop_standing_small
STAND = dict(cfg=MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                           samples_per_stance=4, ee_node_start=1,
                           ipm_iters=15, init_run_iters=3, max_ls_iters=4,
                           dt=0.05).validate(),
             wb=jwbqp.WBQPConfig(ipm_iters=10),
             sim=jengine.SimConfig(substeps=2),
             loop=dict(n_ticks=30, control_dt=0.004, mpc_every=10))
# tests/test_sim_engine.py::test_closed_loop_with_gait_opt_compiles, with
# the schedule sync on
GAIT = dict(cfg=MPCConfig(num_nodes=4, num_phase_slots=4, phase_duration=0.5,
                          samples_per_stance=3, ee_node_start=1, ipm_iters=8,
                          init_run_iters=1, max_ls_iters=2, ls_alphas=2,
                          dt=0.05).validate(),
            wb=jwbqp.WBQPConfig(ipm_iters=8),
            sim=jengine.SimConfig(substeps=1),
            loop=dict(n_ticks=6, control_dt=0.01, mpc_every=2,
                      gait_opt_every=2, contact_sync=True))


def t(a):
    return torch.tensor(np.asarray(a))


def assert_close_rel(port, ref, rtol):
    p, r = convert.to_numpy(port), np.asarray(ref)
    assert p.shape == r.shape
    np.testing.assert_allclose(p, r, rtol=0,
                               atol=rtol * max(np.abs(r).max(), 1e-300))


def setup(case, *, initial_run: bool, dtype=F64):
    """The JAX tests' start (the stand 7 mm down, a standing schedule) for
    B scenarios, the second with its joints moved by 0.01 rad * N(0, 1);
    the MPC state after the port's create_initial_run where asked.  Returns
    the port's arguments of closed_loop and the JAX package's (batch
    first)."""
    cfg, jm = case["cfg"], ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64).at[2].add(-0.007)
    params = jsrb.make_srb_params(jm, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(18))
    feet0 = jrbd.ee_positions(jm, q0)
    traj = jdeft(cfg, jgait.make_standing(cfg), x0, feet0[:, :2])
    st = jsolver.SolverState(traj=jax.tree.map(
        lambda a: jnp.stack([a] * B), traj),
        ee_box=jnp.stack([jnp.asarray(cfg.ee_box_size, jnp.float64)] * B))
    pcfg = convert.from_config(cfg)
    pparams = convert.from_srb_params(params, device="cpu", dtype=dtype)
    pst = convert.from_solver_state(st, device="cpu", dtype=dtype)
    x_des = convert.tensor(jnp.stack([jsrb.manifold_to_tangent(x0)] * B),
                           device="cpu", dtype=dtype)
    if initial_run:
        pst, stats = solver.create_initial_run(
            pcfg, pparams, pst, convert.tensor(jnp.stack([x0] * B),
                                               device="cpu", dtype=dtype),
            convert.tensor(jnp.stack([feet0] * B), device="cpu",
                           dtype=dtype), x_des)
        assert bool(stats.solved.all())
    q0s = np.tile(np.asarray(q0), (B, 1))
    q0s[1, 7:] += 0.01 * np.random.default_rng(0).standard_normal(12)
    port = dict(model=a1.make_a1(device="cpu"), params=pparams, cfg=pcfg,
                wb_cfg=convert.from_wbqp_config(case["wb"]),
                sim=convert.from_sim_config(case["sim"]), state0=pst,
                q0=torch.tensor(q0s, dtype=dtype),
                v0=torch.zeros(B, 18, dtype=dtype), x_des_tan=x_des)
    tr = convert.to_numpy(pst.traj)
    jst = jsolver.SolverState(
        traj=JTraj(x_man=jnp.asarray(tr.x_man), f_nodes=jnp.asarray(
            tr.f_nodes), footholds=jnp.asarray(tr.footholds),
            sched=JSched(bounds=jnp.asarray(tr.sched.bounds))),
        ee_box=jnp.asarray(convert.to_numpy(pst.ee_box)))
    ref = dict(model=jm, params=params, state0=jst, q0=jnp.asarray(q0s),
               x_des=jsrb.manifold_to_tangent(x0))
    return port, ref


def run_port(port, case, **over):
    return engine.closed_loop(**port, **{**case["loop"], **over})


def run_jax(ref, case):
    cfg, wb, sim = case["cfg"], case["wb"], case["sim"]
    m, params, x_des = ref["model"], ref["params"], ref["x_des"]
    run = jit_per_scenario(lambda st, q, v: jengine.closed_loop(
        m, params, cfg, wb, sim, st, q, v, x_des, **case["loop"]))
    return run(ref["state0"], ref["q0"], jnp.zeros((B, 18)))


def assert_logs_close(got_log, want_log, rtol=1e-6):
    """Every field of two logs [T, B, ...] at every tick: NaN where the
    other is, flags equal, values within ``rtol`` of the field's largest
    magnitude over the rollout."""
    for name in engine.SimLog._fields:
        got = convert.to_numpy(getattr(got_log, name))
        want = np.asarray(getattr(want_log, name))
        assert got.shape == want.shape, name
        if got.dtype == bool:
            assert np.array_equal(got, want), name
            continue
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        fin = ~np.isnan(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, err_msg=name,
                                   atol=rtol * np.abs(want[fin]).max())


def assert_rollouts_match(port_out, jax_out, n_ticks):
    st, log = port_out
    jst, jlog = jax_out
    assert log.q.shape[:2] == (n_ticks, B)
    assert_logs_close(log, engine.SimLog(*(np.swapaxes(np.asarray(a), 0, 1)
                                           for a in jlog)))
    assert_close_rel(st.traj.sched.bounds, jst.traj.sched.bounds, 1e-6)
    assert_close_rel(st.traj.x_man, jst.traj.x_man, 1e-6)


# ---------------------------------------------------------------------------
# the physics against the JAX package
# ---------------------------------------------------------------------------

def test_contact_forces_match_jax():
    sim = jengine.SimConfig()
    rng = np.random.default_rng(1)
    feet = rng.uniform(-0.01, 0.04, (3, 4, 3))
    feet[0, :, 2] = 0.1                              # airborne
    vel = rng.standard_normal((3, 4, 3)) * 0.3
    ref = jax.vmap(lambda f, v: jengine.contact_forces(sim, f, v))(feet, vel)
    got = engine.contact_forces(convert.from_sim_config(sim), t(feet), t(vel))
    assert_close_rel(got, ref, 1e-10)
    assert np.all(got[0].numpy() == 0.0) and np.all(got[1:, :, 2].numpy()
                                                    >= 0.0)


def test_physics_step_free_fall_and_standing_match_jax():
    """A configuration 1 m up (free fall: the base accelerates at -g) and
    the settled stand with torques (the ground carries it), one step."""
    jm, pm = ja1.make_a1(), a1.make_a1(device="cpu")
    sim = jengine.SimConfig()
    stand = np.asarray(ja1.stand_config(), np.float64)
    settled = np.asarray(jengine.settled_stand(jm, sim, jnp.asarray(stand)))
    air = stand.copy()
    air[2] = 1.0
    q = np.stack([air, settled])
    rng = np.random.default_rng(2)
    v = np.stack([np.zeros(18), 0.1 * rng.standard_normal(18)])
    tau = np.stack([np.zeros(12), 5.0 * rng.standard_normal(12)])
    ref = jit_per_scenario(lambda *a: jengine.physics_step(jm, sim, *a,
                                                           0.001))(q, v, tau)
    got = engine.physics_step(pm, convert.from_sim_config(sim), t(q), t(v),
                              t(tau), 0.001)
    for g, r in zip(got, ref):
        assert_close_rel(g, r, 1e-10)
    np.testing.assert_allclose(float(got[1][0, 2]), -9.81e-3, rtol=1e-3)


def test_settled_stand_matches_jax():
    jm, pm = ja1.make_a1(), a1.make_a1(device="cpu")
    sim = jengine.SimConfig()
    stand = np.asarray(ja1.stand_config(), np.float64)
    ref = jengine.settled_stand(jm, sim, jnp.asarray(stand))
    got = engine.settled_stand(pm, convert.from_sim_config(sim),
                               t(np.stack([stand] * 2)))
    assert_close_rel(got, np.stack([ref] * 2), 1e-10)
    # every foot at the same penetration: the ground carries the weight
    feet = rbd.ee_positions(pm, got)
    f = engine.contact_forces(convert.from_sim_config(sim), feet,
                              torch.zeros_like(feet))
    np.testing.assert_allclose(f[..., 2].sum(-1).numpy(),
                               float(pm.total_mass) * 9.81, rtol=1e-4)


# ---------------------------------------------------------------------------
# the closed loop against the JAX package
# ---------------------------------------------------------------------------

def test_closed_loop_standing_matches_jax_at_every_tick():
    port, ref = setup(STAND, initial_run=True)
    got = run_port(port, STAND)
    assert_rollouts_match(got, run_jax(ref, STAND), 30)
    z = got[1].q[:, :, 2]
    assert bool(torch.isfinite(got[1].q).all()) and float(z.min()) > 0.2


# ---------------------------------------------------------------------------
# the loop's structure
# ---------------------------------------------------------------------------

def tick_loop(model, params, cfg, wb_cfg, sim, state0, q0, v0, x_des_tan, *,
              n_ticks, control_dt, mpc_every, gait_opt_every=0,
              contact_sync=False):
    """The JAX package's scan body, one tick at a time, from the port's
    building blocks."""
    ls = engine.initial_state(model, cfg, sim, state0, q0, v0)
    q, v, st, t0, mc, trust = ls.q, ls.v, ls.st, ls.t0, ls.mc, ls.trust
    logs = []
    for i in range(n_ticks):
        t_i = (torch.full((), i, dtype=torch.int64).to(q.dtype)
               * control_dt).expand(B)
        feet = rbd.ee_positions(model, q)
        mc = (feet[..., 2] < sim.foot_radius + sim.contact_enter_margin) | (
            mc & (feet[..., 2] < sim.foot_radius + sim.contact_exit_margin))
        if i % mpc_every == 0:
            gait = engine.is_gait_period(i // mpc_every, gait_opt_every)
            st, stats, trust = engine.mpc_update(
                model, params, cfg, dataclasses.replace(
                    ls, q=q, v=v, st=st, trust=trust), t_i, x_des_tan, feet,
                mc, gait=gait, contact_sync=contact_sync)
            cost, solved = stats.cost, stats.solved
            t0 = t_i
        else:
            cost = torch.full((B,), float("nan"), dtype=q.dtype)
            solved = torch.ones(B, dtype=torch.bool)
        tau = mpc_controller.control_action(model, params, cfg, wb_cfg,
                                            st.traj, q, v, t_i, t0, mc)
        for _ in range(sim.substeps):
            q, v = engine.physics_step(model, sim, q, v, tau,
                                       control_dt / sim.substeps)
        logs.append(engine.SimLog(
            q=q, v=v, srb_state=mpc_controller.reconstruct_srb_state(
                model, params, q, v), tau=tau, cost=cost, solved=solved))
    return st, engine.SimLog(*(torch.stack(f) for f in zip(*logs)))


@pytest.fixture(scope="module")
def gait_case():
    return setup(GAIT, initial_run=False)[0]


def test_period_loop_is_the_tick_loop_bit_for_bit(gait_case):
    """Seven ticks: three periods with the gait update in the third, and a
    partial fourth period of one tick."""
    got = run_port(gait_case, GAIT, n_ticks=7)
    want = tick_loop(**gait_case, **{**GAIT["loop"], "n_ticks": 7})
    assert_bitwise(got, want)
    assert got[1].cost.shape == (7, B)
    assert bool(torch.isnan(got[1].cost[1::2]).all())
    assert bool(torch.isfinite(got[1].cost[0::2]).all())


def test_batch_of_two_is_two_batches_of_one(gait_case):
    """Each scenario's rollout is its own: run alone it gives the same log
    to the tolerance of the JAX comparison (measured ~1e-9: the batched
    matrix products sum in a batch-size dependent order)."""
    both = run_port(gait_case, GAIT)

    def alone(i):
        one = {k: tree_map(lambda a: a[i:i + 1], v)
               if k in ("state0", "q0", "v0", "x_des_tan") else v
               for k, v in gait_case.items()}
        return run_port(one, GAIT)

    singles = [alone(i) for i in range(B)]
    assert_logs_close(both[1], tree_map(lambda *a: torch.cat(a, dim=1),
                                        singles[0][1], singles[1][1]))
    bounds = torch.cat([s[0].traj.sched.bounds for s in singles])
    assert_close_rel(both[0].traj.sched.bounds, bounds, 1e-6)


def test_the_loop_keeps_its_inputs(gait_case):
    before = tree_map(torch.clone, gait_case)
    run_port(gait_case, GAIT)
    assert_bitwise(tree_leaves(before), tree_leaves(gait_case))


# ---------------------------------------------------------------------------
# the host-copy guard over the per-tick entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def warm_loop(request):
    """The gait configuration's start in the dtype with the force carrier
    on, its loop state, and one run of each kind of period (which builds
    the constants that every later call shares)."""
    port = setup(GAIT, initial_run=False, dtype=request.param)[0]
    # the flagship's force carrier on: its targets take the model's mass
    port["cfg"] = dataclasses.replace(port["cfg"], force_carrier=True)
    ls = engine.initial_state(port["model"], port["cfg"], port["sim"],
                              port["state0"], port["q0"], port["v0"])
    for gait in (False, True):
        period(port, ls, gait)
    return port, ls


def period(port, ls, gait):
    return engine.period(port["model"], port["params"], port["cfg"],
                         port["wb_cfg"], port["sim"], port["x_des_tan"], ls,
                         control_dt=0.01, ticks=2, gait=gait,
                         contact_sync=True)


@pytest.mark.parametrize("entry", ["control_action", "physics_step",
                                   "rti_period", "gait_period"])
def test_per_tick_path_copies_nothing_from_the_host(warm_loop, no_host_data,
                                                    entry):
    port, ls = warm_loop
    B_ = ls.q.shape[0]
    tt = torch.full((B_,), 0.01, dtype=ls.q.dtype)
    if entry == "control_action":
        mpc_controller.control_action(port["model"], port["params"],
                                      port["cfg"], port["wb_cfg"],
                                      ls.st.traj, ls.q, ls.v, tt, ls.t0,
                                      ls.mc)
    elif entry == "physics_step":
        engine.physics_step(port["model"], port["sim"], ls.q, ls.v,
                            torch.zeros_like(ls.q[:, 7:]), 0.001)
    else:
        period(port, ls, entry == "gait_period")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gait", [False, True], ids=["rti", "gait"])
def test_replayed_period_is_the_eager_period(card, gait):
    from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
    port = setup(GAIT, initial_run=False, dtype=torch.float32)[0]
    port = tree_map(lambda a: a.to(card), port)
    port["model"] = a1.make_a1(device=card)
    ls = engine.initial_state(port["model"], port["cfg"], port["sim"],
                              port["state0"], port["q0"], port["v0"])
    g = Graphed(lambda s: period(port, s, gait), ls,
                carry={0: lambda out: out[0]})
    want = period(port, ls, gait)
    got = g(ls)
    torch.cuda.synchronize()
    assert_bitwise(got, want)


@pytest.mark.cuda
def test_graphed_loop_with_a_partial_last_period_is_the_eager_loop(card):
    """30 ticks at mpc_every=12, batch 2, float32: two whole periods and a
    trailing one of 6 ticks, each kind captured once as a graph, equal bit
    for bit to the same periods run eagerly on the card."""
    port = setup(STAND, initial_run=True, dtype=torch.float32)[0]
    port = tree_map(lambda a: a.to(card), port)
    port["model"] = a1.make_a1(device=card)
    loop = {**STAND["loop"], "mpc_every": 12}
    got = run_port(port, STAND, mpc_every=12)
    ls = engine.initial_state(port["model"], port["cfg"], port["sim"],
                              port["state0"], port["q0"], port["v0"])
    logs = []
    for start in range(0, loop["n_ticks"], 12):
        ls, log = engine.period(
            port["model"], port["params"], port["cfg"], port["wb_cfg"],
            port["sim"], port["x_des_tan"], ls,
            control_dt=loop["control_dt"],
            ticks=min(12, loop["n_ticks"] - start), gait=False,
            contact_sync=False)
        logs.append(log)
    torch.cuda.synchronize()
    assert got[1].q.shape[0] == 30
    assert_bitwise(got, (ls.st, engine.SimLog(*(torch.cat(f)
                                                for f in zip(*logs)))))
