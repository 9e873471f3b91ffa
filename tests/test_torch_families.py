"""The slice as a whole, float64: one bench cadence cycle
(``mpc/cadence.cycle``: nine real-time iterations, then the gait update)
for the Adam biped under its shipped ``configs/adam_march.yaml`` (Raibert
capture stepping, double support, the force carrier, two point feet) cut
to num_nodes=10, against the JAX package's ``solver.solve_step`` x9 and
``bilevel.gait_opt_update`` on the same two perturbed scenarios
(chip_smoke.py phase 11's start).

Tolerances, as tests/test_torch_bilevel.py holds the A1's cadence: the
costs within 1e-6 relative, the planned trajectory within 1e-6, the solved
and accepted flags and the line-search alphas equal (the same sweeps in
float64, interior-point iterates converged to ~1e-9 gaps whose last digits
differ)."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bilevel_gait_gen_tpu.models import adam as jadam, rbd as jrbd
from bilevel_gait_gen_tpu.models import srb as jsrb
from bilevel_gait_gen_tpu.mpc import bilevel as jbilevel, gait as jgait
from bilevel_gait_gen_tpu.mpc import solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu.utils import config as jconfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.mpc import cadence
from bilevel_gait_gen_tpu_torch.problem import perturbations

import chip_smoke
from torch_jax_common import jit_per_scenario

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
B, N, FREQ = 2, 10, 10


def _adam_config():
    """adam_march.yaml's fields at num_nodes=10 (the phase slots as
    load_yaml derives them for that horizon); its 25 sweeps a QP stay: at
    bench.py's 10 the RTIs end less converged, and the gait update's cost
    of one scenario moves 2.5e-6 relative between the two packages."""
    cfg = jconfig.load_yaml(str(ROOT / "bilevel_gait_gen_tpu" / "configs"
                                / "adam_march.yaml"))
    return dataclasses.replace(cfg, num_nodes=N, num_phase_slots=6).validate()


def test_adam_cycle_matches_jax():
    jcfg = _adam_config()
    cfg = convert.from_config(jcfg)
    assert cfg.raibert and cfg.force_carrier and cfg.double_support > 0

    jm = jadam.make_adam()
    q0 = jnp.asarray(jadam.stand_config(), jnp.float64)
    params = jsrb.make_srb_params(jm, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(jm.nv, jnp.float64))
    feet = jrbd.ee_positions(jm, q0)
    traj = default_trajectory(jcfg, jgait.make_trot(jcfg), x0, feet[:, :2])
    state = jsolver.make_state(jcfg, traj,
                               jnp.asarray(jcfg.ee_box_size, jnp.float64))
    states = jax.tree.map(lambda a: jnp.stack([a] * B), state)
    x0s = x0[None] + jnp.asarray(perturbations(B, seed=0))
    x_des = jsrb.manifold_to_tangent(x0)
    t0 = jnp.asarray(0.0)
    step = jit_per_scenario(lambda st, x: jsolver.solve_step(
        jcfg, params, st, x, t0, feet, x_des), jit_fn=jax.jit)
    jsolved = []
    for _ in range(FREQ - 1):
        states, stats = step(states, x0s)
        jsolved.append(np.asarray(stats.solved))
    jres = jit_per_scenario(lambda st, x: jbilevel.gait_opt_update(
        jcfg, params, st, x, t0, feet, x_des), jit_fn=jax.jit)(states, x0s)

    pr = chip_smoke.family_problem("adam", cfg, B, "cpu", torch.float64)
    _, solved, res, _ = cadence.cycle(cfg, pr.params, *pr.loop_args(), FREQ)

    np.testing.assert_array_equal(solved.numpy(), np.stack(jsolved))
    assert bool(solved.all())
    np.testing.assert_array_equal(res.accepted.numpy(),
                                  np.asarray(jres.accepted))
    np.testing.assert_array_equal(res.alpha.numpy(), np.asarray(jres.alpha))
    np.testing.assert_array_equal(res.rti_stats.solved.numpy(),
                                  np.asarray(jres.rti_stats.solved))
    for name in ("cost", "cost0", "trust"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(res.rti_stats.cost.numpy(),
                               np.asarray(jres.rti_stats.cost), rtol=1e-6)
    np.testing.assert_allclose(res.state.traj.x_man.numpy(),
                               np.asarray(jres.state.traj.x_man), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res.state.traj.sched.bounds.numpy(),
                               np.asarray(jres.state.traj.sched.bounds),
                               rtol=0, atol=1e-9)
