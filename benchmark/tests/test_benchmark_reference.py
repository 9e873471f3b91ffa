"""The plain reference agrees with the port's CPU float64 path on a small
problem (the port's CPU path is plain PyTorch too, so they agree to
rounding), and the comparison's numbers see a perturbed answer."""
import numpy as np
import pytest
import torch

from benchmark.harness import a1mpc, compare, seeds
from benchmark.kinds import cadence as kind_cadence
from benchmark.reference import bilevel as rbilevel
from benchmark.reference import engine as rengine
from benchmark.reference import solver as rsolver
from benchmark.reference import start as rstart
from bilevel_gait_gen_tpu_torch.control.wbqp import WBQPConfig
from bilevel_gait_gen_tpu_torch.mpc import bilevel, solver
from bilevel_gait_gen_tpu_torch.sim import engine
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves

MPC = {"num_nodes": 20, "dt": 0.05, "ipm_iters": 10, "ipm_exact_every": 5,
       "ipm_grad_polish": 2}
TIGHT = dict(rtol=1e-10, atol=1e-10)


def close(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x.is_floating_point():
            torch.testing.assert_close(x, y, equal_nan=True, **TIGHT)
        else:
            assert torch.equal(x, y)


@pytest.fixture(scope="module")
def problems():
    cfg = a1mpc.program_config(MPC)
    rcfg = compare.ref_mpc_config(MPC)
    pert = seeds.perturbations(2, 5)
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    import dataclasses
    pr = make_problem(cfg, 2, device="cpu", dtype=torch.float64)
    pr = dataclasses.replace(pr, x0s=pr.states.traj.x_man[:, 0]
                             + torch.tensor(pert))
    rp = rstart.make_problem(rcfg, 2, pert, device="cpu")
    return cfg, rcfg, pr, rp


def test_start_agrees(problems):
    _, _, pr, rp = problems
    assert a1mpc.start_gap(pr, rp) == 0.0


def test_rti_and_gait_update_agree(problems):
    cfg, rcfg, pr, rp = problems
    st, stats = solver.solve_step(cfg, pr.params, *pr.loop_args())
    rst, rstats = rsolver.solve_step(rcfg, rp.params, *rp.loop_args())
    close((st, stats), (rst, rstats))
    g = bilevel.gait_opt_update(cfg, pr.params, st, *pr.loop_args()[1:])
    rg = rbilevel.gait_opt_update(rcfg, rp.params, rst, *rp.loop_args()[1:])
    close(g, rg)


def test_period_agrees():
    cfg = a1mpc.program_config({"ipm_iters": 18, "force_carrier": True,
                                "double_support": 0.15,
                                "carrier_ramp": 0.15, "swing_height": 0.05})
    rcfg = compare.ref_mpc_config({"ipm_iters": 18, "force_carrier": True,
                                   "double_support": 0.15,
                                   "carrier_ramp": 0.15,
                                   "swing_height": 0.05})
    sim, rsim = engine.SimConfig(), rengine.SimConfig()
    wb, rwb = WBQPConfig(torque_bound=30.0), compare.ref_wb_config(
        {"torque_bound": 30.0})
    dq = seeds.joint_perturbations(2, 12, 3, 0.01)
    model, params, states, q0s, v0, x_des, ok = rstart.loop_start(
        rcfg, rsim, 1.25, dq, device="cpu")
    assert bool(ok.all())
    ls = rengine.initial_state(model, rcfg, rsim, states, q0s, v0)
    want = rengine.period(model, params, rcfg, rwb, rsim, x_des, ls,
                          control_dt=1e-3, ticks=3, gait=True,
                          contact_sync=True)
    from bilevel_gait_gen_tpu_torch.models import a1, srb
    pmodel = a1.make_a1(device="cpu")
    pparams = srb.SRBParams(*[getattr(params, f) for f in (
        "mass", "inertia", "inertia_inv", "hip_offset", "com_offset",
        "hip_offset_raw")])
    from bilevel_gait_gen_tpu_torch.mpc import gait, trajectory
    from bilevel_gait_gen_tpu_torch.ops import pdip

    def port(tree):
        # the reference's start in the port's classes
        cls = {"SolverState": solver.SolverState,
               "Trajectory": trajectory.Trajectory,
               "GaitSchedule": gait.GaitSchedule,
               "QPSolution": pdip.QPSolution}
        import dataclasses
        if isinstance(tree, torch.Tensor):
            return tree
        return cls[type(tree).__name__](**{
            f.name: port(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})

    pls = engine.initial_state(pmodel, cfg, sim, port(states), q0s, v0)
    got = engine.period(pmodel, pparams, cfg, wb, sim, x_des, pls,
                        control_dt=1e-3, ticks=3, gait=True,
                        contact_sync=True)
    close(got[1], want[1])
    close(got[0].q, want[0].q)


def test_numbers_see_a_perturbed_answer():
    r = {"solved": torch.ones(4, 9, dtype=torch.bool),
         "rti_solved": torch.ones(4, dtype=torch.bool),
         "rti_cost": torch.full((4,), 100.0), "rti_obj": torch.ones(4),
         "x_man": torch.ones(4, 21, 13), "bounds": torch.zeros(4, 4, 9),
         "trust": torch.ones(4), "accepted": torch.ones(4, dtype=torch.bool),
         "gait_cost": torch.full((4,), -50.0), "x0": torch.ones(4, 13)}
    same = kind_cadence.numbers(r, r)
    assert same["solved_flags_differ"] == 0 and same[
        "gait_cost_rel_median"] == 0 and same["plan_start_max"] == 0
    bad = dict(r, solved=r["solved"].clone(), gait_cost=r["gait_cost"] * 1.5,
               x_man=r["x_man"].clone())
    bad["solved"][0, 3] = False
    bad["x_man"][2, 0, 1] += 0.03
    got = kind_cadence.numbers(bad, r)
    assert got["solved_flags_differ"] == 1
    assert np.isclose(got["gait_cost_rel_median"], 0.5)
    assert np.isclose(got["plan_start_max"], 0.03)


def test_off_step_sees_a_foreign_plan_start():
    from benchmark.kinds import closed_loop
    from benchmark.reference import srb as rsrb
    a = torch.tensor([0.0, 0, 0.3, 0.1, 0, 0, 0.01, 0.02, 0.0, 0, 0, 0],
                     dtype=torch.float64)
    b = a + torch.linspace(0.01, 0.12, 12, dtype=torch.float64)
    man = rsrb.tangent_to_manifold
    for share in (0.0, 0.5, 1.0):
        assert closed_loop.off_step(man(a + share * (b - a)), man(a),
                                    man(b)) < 1e-12
    foreign = a + 0.5 * (b - a)
    foreign[2] += 0.05
    assert np.isclose(closed_loop.off_step(man(foreign), man(a), man(b)),
                      0.05, rtol=0.2)
