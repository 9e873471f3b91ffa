"""The port's demo scripts without MuJoCo (scripts/torch_mpc_demo.py,
torch_batch_sim_demo.py, torch_diag_engine.py) against the JAX package's,
float64 on the CPU.

* the slice as a whole: mpc_demo's sequence (the initial run, 3 RTIs, one
  gait update) at tests/test_parallel.py's small configuration through
  ``torch_mpc_demo.solve``, against the same JAX calls, one ``jax.jit`` per
  function: every stats row, the final plan and the gait update's results
  within 1e-6 of each quantity's largest magnitude (measured ~1e-11: the
  interior-point solves amplify float64 rounding; an error of formulation
  moves them by 1e-3 or more);
* each script's setup (the start configuration, the SRB parameters, the
  SRB state, the feet, the trajectory and the solver state) against the
  lines of the JAX script that build it, 1e-12 of each array's magnitude;
* each script's ``main`` run short on the CPU: its exit code and its
  printed lines; without ``--cpu`` (``DIAG_CPU``) and without a card each
  raises instead of running on the CPU.

The loops' numerics are held by test_torch_engine.py and
test_torch_closed_loop*.py; no JAX closed loop runs here.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.control import mpc_controller as jmc
from bilevel_gait_gen_tpu.control import wbqp as jwbqp
from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import bilevel as jbilevel, gait as jgait
from bilevel_gait_gen_tpu.mpc import solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory as jdeft
from bilevel_gait_gen_tpu.ops import spline as jspline
from bilevel_gait_gen_tpu.sim import engine as jengine
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from torch_jax_common import jit

torch.set_num_threads(2)

F64 = torch.float64
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
# tests/test_parallel.py:21-24
SMALL = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                  samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                  init_run_iters=2, max_ls_iters=4, dt=0.05).validate()


def script(name: str):
    """``scripts/<name>.py`` as a module (its ``main`` is not run)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def np64(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def assert_rel(got, want, rtol, what=""):
    g, w = np64(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(
        np.abs(w).max(initial=0.0), 1e-300), err_msg=what)


def assert_start(port, ref, rtol=1e-12):
    """A script's start (model, q0, params, x0, feet0, state, x_des; the
    port's batch first with a batch of one) against the JAX script's."""
    _, q0, params, x0, feet0, st, x_des = port
    jq0, jparams, jx0, jfeet0, jst, jx_des = ref
    assert_rel(q0, jq0, rtol, "q0")
    for f in dataclasses.fields(params):
        assert_rel(getattr(params, f.name), getattr(jparams, f.name), rtol,
                   f.name)
    assert_rel(x0[0], jx0, rtol, "x0")
    assert_rel(feet0[0], jfeet0, rtol, "feet0")
    assert_rel(x_des[0], jx_des, rtol, "x_des")
    tr, jtr = st.traj, jst.traj
    for name in ("x_man", "f_nodes", "footholds"):
        assert_rel(getattr(tr, name)[0], getattr(jtr, name), rtol, name)
    assert_rel(tr.sched.bounds[0], jtr.sched.bounds, rtol, "bounds")
    assert_rel(st.ee_box[0], jst.ee_box, rtol, "ee_box")
    assert (st.qp_warm is None) == (jst.qp_warm is None)
    if st.qp_warm is not None:
        for f in dataclasses.fields(st.qp_warm):
            assert_rel(getattr(st.qp_warm, f.name)[0],
                       getattr(jst.qp_warm, f.name), rtol, f.name)


def jax_start(cfg, q0, sched, *, reconstruct=jsrb.reconstruct_state,
              warm=False):
    """The JAX scripts' common lines from a start configuration q0."""
    model = ja1.make_a1()
    params = jsrb.make_srb_params(model, q0)
    if reconstruct is jmc.reconstruct_srb_state:
        x0 = reconstruct(model, params, q0, jnp.zeros(model.nv))
    else:
        x0 = reconstruct(params, q0, jnp.zeros(model.nv))
    feet0 = jrbd.ee_positions(model, q0)
    traj = jdeft(cfg, sched, x0, feet0[:, :2])
    box = jnp.asarray(cfg.ee_box_size, jnp.float64)
    st = (jsolver.make_state(cfg, traj, box) if warm else
          jsolver.SolverState(traj=traj, ee_box=box))
    return q0, params, x0, feet0, st, jsrb.manifold_to_tangent(x0)


# ---------------------------------------------------------------------------
# the slice as a whole: mpc_demo's sequence
# ---------------------------------------------------------------------------

def jax_mpc_demo(cfg, n_iters):
    """mpc_demo.py:31-77 in float64 (no plot): the initial run's stats, the
    RTIs' stats, the gait update's result."""
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    _, params, x0, feet0, state, x_des = jax_start(cfg, q0,
                                                   jgait.make_trot(cfg))
    state, init_stats = jit(lambda s, x, e: jsolver.create_initial_run(
        cfg, params, s, x, e, x_des))(state, x0, feet0)
    step = jit(lambda st, x, t, ee: jsolver.solve_step(
        cfg, params, st, x, t, ee, x_des))
    rows = []
    for k in range(1, n_iters + 1):
        t0 = jnp.asarray(cfg.dt * k, jnp.float64)
        feet = jax.vmap(lambda b, fh: jspline.foot_position(
            b, fh, t0, cfg.swing_height, cfg.foot_offset))(
            state.traj.sched.bounds, state.traj.footholds)
        state, stats = step(state, state.traj.x_man[1], t0, feet)
        rows.append(stats)
    res = jit(lambda st, x, t, ee: jbilevel.gait_opt_update(
        cfg, params, st, x, t, ee, x_des))(
        state, state.traj.x_man[0], jnp.asarray(cfg.dt * n_iters,
                                                jnp.float64), feet)
    return init_stats, rows, res


STAT_COLUMNS = ("defect_l1", "step_norm", "alpha", "cost", "merit")


def test_mpc_demo_slice_matches_jax(capsys):
    """The initial run, 3 RTIs and one gait update: the port's
    ``torch_mpc_demo.solve`` against the JAX calls of mpc_demo.py."""
    demo = script("torch_mpc_demo")
    run = demo.solve(convert.from_config(SMALL), 3, True, "cpu", F64)
    out = capsys.readouterr().out
    init_stats, rows, res = jax_mpc_demo(SMALL, 3)
    assert "CreateInitialRun ..." in out and "bilevel gait update" in out
    assert "3 real-time iterations, avg" in out
    assert bool(run.init_stats.solved) and bool(init_stats.solved)
    for name in STAT_COLUMNS:
        assert_rel(getattr(run.init_stats, name)[0],
                   getattr(init_stats, name), 1e-6, f"init {name}")
    from bilevel_gait_gen_tpu_torch.utils.stats import COLUMNS
    data = np64(run.ring.data)
    assert int(run.ring.head) == 3
    for k, stats in enumerate(rows):
        assert data[k, 0] == k + 1
        for name in STAT_COLUMNS + ("solved",):
            assert_rel(data[k, COLUMNS.index(name)],
                       np.asarray(getattr(stats, name), np.float64), 1e-6,
                       f"RTI {k + 1} {name}")
    for name in ("alpha", "cost", "grad_norm", "cost0", "trust"):
        assert_rel(getattr(run.gait, name)[0], getattr(res, name), 1e-6,
                   name)
    assert bool(run.gait.accepted[0]) == bool(res.accepted)
    tr, jtr = run.state.traj, res.state.traj
    for name in ("x_man", "f_nodes", "footholds"):
        assert_rel(getattr(tr, name)[0], getattr(jtr, name), 1e-6, name)
    assert_rel(tr.sched.bounds[0], jtr.sched.bounds, 1e-6, "bounds")
    # the RTIs moved the plan (at this 0.3 s horizon no phase bound lies in
    # the window after 3 RTIs: the outer gradient is ~0 in both packages
    # and the gait update keeps the schedule; tests/test_torch_bilevel.py
    # holds updates that step)
    costs = [float(r.cost) for r in rows]
    assert min(abs(a - b) for a, b in zip(costs, costs[1:])) > 1.0


# ---------------------------------------------------------------------------
# each script's setup against the JAX script's lines
# ---------------------------------------------------------------------------

def test_mpc_demo_setup_matches_jax():
    cfg = MPCConfig(ipm_iters=18).validate()
    port = script("torch_mpc_demo").setup(convert.from_config(cfg), "cpu",
                                          F64)
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    assert_start(port, jax_start(cfg, q0, jgait.make_trot(cfg)))


def jax_batch_sim(argv):
    """batch_sim_demo.py:53-100 in float64: (cfg, wb_cfg, sim, control_dt,
    mpc_every, the start)."""
    if "--big" in argv:
        control_dt, mpc_every = 0.001, 50
        cfg = MPCConfig(ipm_iters=18).validate()
        wb_cfg, sim = jwbqp.WBQPConfig(), jengine.SimConfig(substeps=1)
    else:
        control_dt, mpc_every = 0.004, 12
        if "--trot" in argv:
            cfg = MPCConfig(num_nodes=12, num_phase_slots=8,
                            samples_per_stance=6,
                            ipm_iters=12, max_ls_iters=6).validate()
        else:
            cfg = MPCConfig(num_nodes=6, num_phase_slots=4,
                            phase_duration=0.5, samples_per_stance=4,
                            ee_node_start=1, ipm_iters=15, init_run_iters=3,
                            max_ls_iters=4).validate()
        wb_cfg = jwbqp.WBQPConfig(ipm_iters=12)
        sim = jengine.SimConfig(substeps=2)
    model = ja1.make_a1()
    q0_np = np.asarray(ja1.stand_config(), np.float64)
    feet_z0 = jrbd.ee_positions(model, jnp.asarray(q0_np))[:, 2]
    pen_eq = float(model.total_mass) * 9.81 / (4 * sim.contact_kp)
    q0_np[2] -= float(jnp.max(feet_z0)) - sim.foot_radius + pen_eq
    sched = (jgait.make_trot(cfg) if "--trot" in argv
             else jgait.make_standing(cfg))
    start = jax_start(cfg, jnp.asarray(q0_np), sched,
                      reconstruct=jmc.reconstruct_srb_state)
    return cfg, wb_cfg, sim, control_dt, mpc_every, start


@pytest.mark.parametrize("argv", [[], ["--trot"], ["--big"], ["4", "20"]],
                         ids=["standing", "trot", "big", "batch_ticks"])
def test_batch_sim_demo_setup_matches_jax(argv):
    bsd = script("torch_batch_sim_demo")
    run = bsd.configure(argv)
    cfg, wb_cfg, sim, control_dt, mpc_every, start = jax_batch_sim(argv)
    assert dataclasses.asdict(run["cfg"]) == dataclasses.asdict(cfg)
    assert run["wb_cfg"] == convert.from_wbqp_config(wb_cfg)
    assert run["sim"] == convert.from_sim_config(sim)
    assert (run["control_dt"], run["mpc_every"]) == (control_dt, mpc_every)
    args = [a for a in argv if not a.startswith("--")]
    assert (run["B"], run["n_ticks"]) == (
        (int(args[0]), int(args[1])) if args else (16, 100))
    assert run["pert"] == 0.01
    assert_start(bsd.setup(run["cfg"], run["sim"], run["trot"], "cpu", F64),
                 start)


def test_batch_sim_demo_batch_is_seeded():
    """The batch: B copies of the solved plan, the stand with seeded joint
    perturbations of ``--pert`` (a ``torch.Generator`` seeded 0), zero
    velocities."""
    bsd = script("torch_batch_sim_demo")
    a = bsd.prepare(["3", "5", "--pert=0.02"], "cpu", F64)["loop"]
    b = bsd.prepare(["3", "5", "--pert=0.02"], "cpu", F64)["loop"]
    torch.testing.assert_close(a["q0"], b["q0"], rtol=0, atol=0)
    base = a["q0"][:, :7]
    assert bool((base == base[0]).all())
    dq = 0.02 * torch.randn((3, 12), generator=torch.Generator()
                            .manual_seed(0), dtype=F64)
    joints = a["q0"][:, 7:] - dq
    torch.testing.assert_close(joints, joints[0:1].expand(3, -1), rtol=0,
                               atol=1e-15)
    assert float(dq.abs().min()) > 0.0
    assert a["state0"].traj.x_man.shape[0] == 3
    assert bool((a["v0"] == 0).all()) and a["x_des_tan"].shape == (3, 12)


def jax_diag(env):
    """diag_engine.py:37-70 in float64 with the environment ``env``."""
    cfg = MPCConfig(ipm_iters=18,
                    double_support=float(env.get("DOUBLE_SUPPORT", "0.15")),
                    force_carrier=bool(int(env.get("FORCE_CARRIER", "1"))),
                    carrier_ramp=float(env.get("CARRIER_RAMP", "0.15")),
                    swing_height=float(env.get("SWING_HEIGHT", "0.05")),
                    raibert=bool(int(env.get("RAIBERT", "0"))),
                    ).validate()
    damp = float(env.get("CONTACT_DAMP", "0"))
    gs = float(env.get("GAIN_SCALE", "1"))
    tb = float(env.get("TORQUE_BOUND", "30"))
    wb_cfg = jwbqp.WBQPConfig(contact_damp=damp, torque_bound=tb,
                              kp_base_pos=9000.0 * gs,
                              kd_base_pos=3000.0 * gs,
                              kp_base_ang=1000.0 * gs,
                              kd_base_ang=100.0 * gs)
    sim = jengine.SimConfig(substeps=int(env.get("SUBSTEPS", "4")),
                            contact_kp=float(env.get("CONTACT_KP", "12000")),
                            contact_kd=float(env.get("CONTACT_KD", "120")),
                            tangent_vel_reg=float(env.get("TVREG", "0.05")))
    model = ja1.make_a1()
    q0 = jengine.settled_stand(model, sim, jnp.asarray(ja1.stand_config(),
                                                       jnp.float64))
    start = jax_start(cfg, q0, jgait.make_trot(cfg),
                      reconstruct=jmc.reconstruct_srb_state, warm=True)
    return cfg, wb_cfg, sim, start


@pytest.mark.parametrize("env", [
    {}, {"CONTACT_DAMP": "2", "GAIN_SCALE": "0.5", "TORQUE_BOUND": "25",
         "SUBSTEPS": "2", "CONTACT_KP": "9000", "RAIBERT": "1",
         "DOUBLE_SUPPORT": "0.1", "MPC_EVERY": "40", "CONTACT_SYNC": "0"}],
    ids=["defaults", "knobs"])
def test_diag_engine_setup_matches_jax(env):
    diag = script("torch_diag_engine")
    c = diag.configure(env)
    cfg, wb_cfg, sim, start = jax_diag(env)
    assert dataclasses.asdict(c["cfg"]) == dataclasses.asdict(cfg)
    assert c["wb_cfg"] == convert.from_wbqp_config(wb_cfg)
    assert c["sim"] == convert.from_sim_config(sim)
    assert c["mpc_every"] == int(env.get("MPC_EVERY", "50"))
    assert c["contact_sync"] == bool(int(env.get("CONTACT_SYNC", "1")))
    assert_start(diag.setup(c["cfg"], c["sim"], "cpu", F64), start)


# ---------------------------------------------------------------------------
# each main, short, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def no_files(monkeypatch, tmp_path):
    """Plots and dumps go into the test's own directory."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_mpc_demo_main_runs_short(monkeypatch, capsys, no_files):
    demo = script("torch_mpc_demo")
    monkeypatch.setattr(demo, "N_ITERS", 3)
    assert demo.main(["--cpu", "--gait-opt"]) == 0
    out = capsys.readouterr().out
    assert "  solved=True" in out
    assert "3 real-time iterations, avg" in out
    assert "solve |    time_ms" in out
    assert "  alpha=" in out and "|grad|=" in out
    assert f"plan plot: {no_files / 'mpc_plan.png'}" in out
    assert (no_files / "mpc_plan.png").stat().st_size > 1000


def test_batch_sim_demo_main_runs_short(capsys):
    """2 robots, 14 ticks at mpc_every=12: a whole period and a trailing
    one of 2 ticks."""
    assert script("torch_batch_sim_demo").main(["2", "14", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "initial run: solved=True" in out
    assert "2 robots x 0.06 s sim: compile+run" in out
    assert "upright: 2/2" in out


def test_diag_engine_main_runs_short(monkeypatch, capsys):
    """60 ticks at mpc_every=50: a whole period and a trailing one of 10."""
    monkeypatch.setenv("DIAG_CPU", "1")
    assert script("torch_diag_engine").main(["60"]) == 0
    out = capsys.readouterr().out
    assert "initial: solved=True" in out
    assert "MPC ticks: solved = [1, 1]" in out
    assert "t=0.00 z=0.29" in out
    assert "final z=0.2" in out


@pytest.mark.parametrize("name, argv", [
    ("torch_mpc_demo", ["--gait-opt"]),
    ("torch_batch_sim_demo", ["2", "12"]),
    ("torch_diag_engine", ["50"]),
    ("torch_run_mujoco_walk", ["0.1"]),
    ("torch_gait_opt_experiment", ["0.1"]),
    ("torch_hardware_sim_demo", ["0.1"]),
])
def test_main_without_cpu_needs_the_card(monkeypatch, name, argv):
    """Without ``--cpu`` (``DIAG_CPU``) a demo runs on the GPU: with none
    it raises before it runs anything, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the demo would run on it")
    monkeypatch.delenv("DIAG_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script(name).main(argv)
