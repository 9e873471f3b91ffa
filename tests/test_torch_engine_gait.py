"""The port's closed loop with the bilevel gait update on its cadence
against the JAX package's, float64: the configuration of
tests/test_sim_engine.py::test_closed_loop_with_gait_opt_compiles (6 ticks,
an MPC update every 2, the third a gait update) with the schedule sync on,
batch 2 on the port's side against ``jax.jit(closed_loop)`` on each scenario
(``torch_jax_common.jit_per_scenario``), every log field at every tick and
the final schedule within 1e-6 of their largest magnitude (measured ~1e-10,
as for the standing rollout of tests/test_torch_engine.py).  Its own file:
tracing and compiling the reference takes a minute and more on the CPU."""
import numpy as np
import torch

from test_torch_engine import GAIT, assert_rollouts_match, run_jax, \
    run_port, setup

torch.set_num_threads(2)


def test_closed_loop_with_gait_update_matches_jax_at_every_tick():
    port, ref = setup(GAIT, initial_run=False)
    got = run_port(port, GAIT)
    assert_rollouts_match(got, run_jax(ref, GAIT), GAIT["loop"]["n_ticks"])
    # the MPC updates at ticks 0, 2 and 4, the last a gait update
    cost = got[1].cost.numpy()
    assert np.isfinite(cost[0::2]).all() and np.isnan(cost[1::2]).all()
