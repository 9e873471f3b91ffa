"""The port's own ``run_closed_loop`` (``bilevel_gait_gen_tpu_torch/sim/
closed_loop.py``) against the JAX package's on one run through a goal
carrot's arrival and the switch to the standing MPC (float64, the CPU):
the scenario of ``torch_closed_loop_common`` (A1 at 0.3 m/s toward a goal
6 cm ahead, gait updates, a push of -0.2 m/s at 0.1 s that brakes the
walk, the arrival at 0.162 s, the standing MPC's first RTI at 0.212 s),
each package's controller in its own MuJoCo loop.  The port's run arrives
at the JAX run's time with its MPC ticks, failures, accepted gait updates
and costs (rtol 1e-6), and its MuJoCo trajectory lies within 1e-6 of the
JAX run's over the first 50 ticks.  ``test_torch_closed_loop.py`` holds
the port's controller to the JAX run tick by tick."""
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.models import a1
from bilevel_gait_gen_tpu_torch.sim import closed_loop as pcl

import torch_closed_loop_common as common

torch.set_num_threads(2)

TOL_QS = 1e-6       # m / rad, the MuJoCo trajectories' first 50 ticks


@pytest.fixture(scope="module")
def port_run():
    """The port's ``run_closed_loop`` on the scenario (it needs no JAX run,
    so it comes first: the JAX run may still be recording elsewhere)."""
    model, cfg, wb, q0, v0, kw = common.scenario_kwargs()
    return cfg, pcl.run_closed_loop(
        a1.make_a1(device="cpu"), convert.from_config(cfg),
        convert.from_wbqp_config(wb), q0, v0, common.SECONDS,
        carrot=pcl.GoalCarrot(goal=common.GOAL), push=common.PUSH,
        device="cpu", dtype=torch.float64, **kw)


@pytest.fixture(scope="module")
def scenario(port_run, tmp_path_factory):
    return common.recorded_scenario(tmp_path_factory)


def test_run_closed_loop_arrives_with_jax(port_run, scenario):
    cfg, got = port_run
    res = scenario[6]
    assert 0.0 < got.arrived_t < common.SECONDS - cfg.dt
    assert got.arrived_t == res.arrived_t
    assert got.n_mpc == res.n_mpc and got.n_fails == res.n_fails
    assert got.n_gait_accepts == res.n_gait_accepts >= 1
    assert got.flight_s == res.flight_s > 0.0
    np.testing.assert_allclose(got.costs, res.costs, rtol=common.TOL_COST)


def test_run_closed_loop_matches_jax_run(port_run, scenario):
    cfg, got = port_run
    res = scenario[6]
    assert got.qs.shape == res.qs.shape and got.taus.shape == res.taus.shape
    np.testing.assert_allclose(got.qs[:50], res.qs[:50], rtol=0, atol=TOL_QS)
    assert got.final_state.traj.x_man.shape == (cfg.num_nodes + 1, 13)
    assert got.final_bounds.shape == res.final_bounds.shape
    assert got.mpc_ms > 0.0 and got.ctrl_ms > 0.0
