"""The port's closed-loop harness (``bilevel_gait_gen_tpu_torch/sim/
closed_loop.py``) against the JAX package's, in float64 on the CPU.

* ``GoalCarrot`` mirrors tests/test_closed_loop_units.py:56 and has the
  JAX dataclass's fields and defaults; ``settled_start`` and
  ``push_recovery_scenario`` equal the JAX package's ``settled_start`` and
  ``run_push_recovery``'s configuration and start;
* tick by tick: the JAX package's ``run_closed_loop`` runs the scenario of
  ``torch_closed_loop_common`` in MuJoCo (RTIs, gait updates, an airborne
  tick, a push, a goal carrot's arrival and the standing MPC) with a
  recording ``MujocoLoop`` in its module's namespace; the port's
  ``ClosedLoopController`` is fed the recorded (q, v, t, contacts) and held
  to it: the counts of MPC ticks, failures and accepted gait updates, the
  airborne time, the arrival, the final schedule (1e-5 s), every MPC
  tick's cost (rtol 1e-6) and every control tick's torques (2e-6 of the
  tick's largest where the torque QP converges).
``test_torch_closed_loop_carrot.py`` runs the port's own ``run_closed_loop``
on the same scenario.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.sim import closed_loop as jcl
from bilevel_gait_gen_tpu_torch.models import a1
from bilevel_gait_gen_tpu_torch.sim import closed_loop as pcl

import torch_closed_loop_common as common

torch.set_num_threads(2)

TOL_BOUNDS = 1e-5   # s, the schedule after the last gait update
N_MPC = 5           # MPC ticks: 0, 0.05 (gait), 0.1, 0.15 (gait), 0.212
                    # (standing)


def test_goal_carrot_stopping_point_and_caps():
    c = pcl.GoalCarrot(goal=(0.5, 0.0))
    assert tuple(np.asarray(c.int_cap)) == (0.06, 0.0)
    assert c.ki == 0.0                       # opt-in
    assert c.v_deadband > 0.0                # march-in-place near goal
    ours = [(f.name, f.default) for f in dataclasses.fields(pcl.GoalCarrot)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jcl.GoalCarrot)]
    assert ours == theirs


def test_settled_start_matches_jax():
    from bilevel_gait_gen_tpu.models import a1 as ja1
    stand = np.asarray(ja1.stand_config(), np.float64)
    want = jcl.settled_start(ja1.make_a1(), stand)
    got = pcl.settled_start(a1.make_a1(device="cpu"), stand)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.dtype == np.float64


def test_push_recovery_config_matches_jax_field_by_field():
    (jm, jcfg, jwb, jq0, jv0, js), jkw = common.push_recovery_args(
        gait_opt_freq=3)
    m, cfg, wb, q0, v0, kw = pcl.push_recovery_scenario(gait_opt_freq=3,
                                                        device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(wb) == dataclasses.asdict(jwb)
    np.testing.assert_allclose(q0, jq0, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(v0, jv0)
    assert m.joint_names == tuple(jm.joint_names)
    jkw.pop("dtype")
    assert kw == jkw
    # run_push_recovery runs this scenario for JAX's default seconds
    seconds = inspect.signature(pcl.run_push_recovery).parameters["seconds"]
    assert seconds.default == js


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return common.recorded_scenario(tmp_path_factory)


@pytest.fixture(scope="module")
def replayed(scenario):
    """The port's controller fed the JAX run's recorded ticks: (the
    controller after the run, its torques, its torque QP's convergence a
    tick, each tick's distance to the JAX run's torques)."""
    model, cfg, wb, q0, v0, kw, res, rec = scenario
    ctl = common.port_controller(cfg, wb, q0, v0, **kw)
    taus, solved = common.replay(ctl, rec)
    return ctl, taus, solved, common.tick_distances(taus, rec)


def test_scenario_covers_rtis_gait_updates_flight_and_push(scenario):
    model, cfg, wb, q0, v0, kw, res, rec = scenario
    assert len(rec) == int(common.SECONDS * 1000)
    assert res.n_mpc == N_MPC and res.n_gait_accepts >= 1
    assert res.flight_s > 0.0 and any(not r[3].any() for r in rec)
    assert any(r[2] >= common.PUSH[0] for r in rec)
    # an airborne tick before a walking MPC tick: its schedule hold applied
    t_air = min(r[2] for r in rec if not r[3].any())
    assert cfg.dt * (1 + int(t_air / cfg.dt)) < res.arrived_t
    # the carrot's arrival, then a standing MPC tick
    assert 0.0 < res.arrived_t < common.SECONDS - cfg.dt


def test_mpc_counts_flight_and_schedule_match(scenario, replayed):
    model, cfg, wb, q0, v0, kw, res, rec = scenario
    ctl = replayed[0]
    assert ctl.n == res.n_mpc
    assert ctl.fails == res.n_fails
    assert ctl.accepts == res.n_gait_accepts
    assert ctl.flight_s == res.flight_s
    # the accepted gait step moves the bounds by the projection QP's
    # solution: TOL_COST's amplification of the last bits, in seconds
    np.testing.assert_allclose(ctl.state.traj.sched.bounds[0].numpy(),
                               res.final_bounds, rtol=0, atol=TOL_BOUNDS)


def test_goal_carrot_arrival_and_standing_mpc_tick_by_tick(scenario,
                                                           replayed):
    model, cfg, wb, q0, v0, kw, res, rec = scenario
    ctl, _, solved, _ = replayed
    assert ctl.standing and ctl.arrived_t == res.arrived_t
    # MPC ticks on both sides of the arrival
    n_walk = sum(1 for r in rec if r[2] < res.arrived_t
                 and abs(r[2] / cfg.dt - round(r[2] / cfg.dt)) < 1e-9)
    assert 1 <= n_walk < ctl.n
    # the standing controller's torque QP converges after the arrival
    k_arr = next(k for k, r in enumerate(rec) if r[2] >= res.arrived_t)
    assert solved[k_arr:].any()


@pytest.mark.parametrize("k", range(N_MPC))
def test_mpc_tick_cost_matches(scenario, replayed, k):
    costs = replayed[0].costs
    assert len(costs) == len(scenario[6].costs)
    np.testing.assert_allclose(costs[k], scenario[6].costs[k],
                               rtol=common.TOL_COST)


def test_converged_control_ticks_match(replayed):
    _, _, solved, d = replayed
    common.check_converged_ticks(d, solved, slice(None))


def test_capped_control_ticks_mostly_match(replayed):
    _, _, solved, d = replayed
    n_solved, n_capped = common.check_capped_ticks(d, solved)
    assert n_solved >= 50 and n_capped >= 20
