"""The port's MuJoCo demo scripts (scripts/torch_run_mujoco_walk.py,
torch_gait_opt_experiment.py, torch_hardware_sim_demo.py) against the JAX
package's, on the CPU.

* each script's configuration and start (the configs, the settled start
  configuration, the schedule; the hardware demo's SRB start and solver
  state) against the lines of the JAX script that build them, float64 to
  1e-12 of each array's magnitude; the Adam biped's start comes from
  float32 IK in both scripts, held to 2e-5;
* each ``main`` run short (0.3 s of simulated time at 1 kHz in MuJoCo):
  its exit code and its printed verdict; the gait-optimization A/B at
  ``--stretch=1.25 --freq=2``, so that the gait-on arm takes gait updates
  (the Raibert rows give its QP p > 32 equality rows).

The controller's numerics against the JAX package are held by
test_torch_closed_loop*.py; no JAX closed loop runs here.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.control import ik as jik, wbqp as jwbqp
from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd
from bilevel_gait_gen_tpu.mpc import gait as jgait
from bilevel_gait_gen_tpu.sim import closed_loop as jcl
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from test_torch_demos import F64, assert_rel, assert_start, jax_start, script

torch.set_num_threads(1)


def jax_walk(argv):
    """run_mujoco_walk.py:38-175 before the run, in float64 but for the
    Adam IK's float32: (model, cfg, wb_cfg, q0, v0, sched, carrot kwargs,
    push, goal, gait_opt_freq)."""
    if "--config=push" in argv:
        cfg = MPCConfig(num_nodes=50, dt=0.02, ipm_iters=18,
                        force_bound=200.0, friction_coef=0.6,
                        force_cost=0.001, contact_snap_window=0.25,
                        q_diag=(140.0, 140.0, 12000.0, 0.015, 0.015, 10.0,
                                3000.0, 3000.0, 3000.0, 1.0, 1.0, 1.0)
                        ).validate()
    else:
        cfg = MPCConfig(ipm_iters=18, contact_snap_window=0.25).validate()
    if "--raibert" in argv:
        cfg = dataclasses.replace(cfg, raibert=True,
                                  raibert_vel_gain=1.0).validate()
    wb_cfg = jwbqp.WBQPConfig()
    carrot_kw = dict(radius=0.25)
    if "--robot=mini_cheetah" in argv:
        from bilevel_gait_gen_tpu.models import mini_cheetah as robot_mod
        model = robot_mod.make_mini_cheetah()
        q0_np = np.asarray(robot_mod.stand_config(), np.float64)
        cfg = dataclasses.replace(cfg, double_support=0.1,
                                  force_carrier=True,
                                  carrier_ramp=0.1).validate()
        wb_cfg = jwbqp.WBQPConfig(torque_bound=float(model.effort_limit[0]),
                                  kp_joint=300.0, kd_joint=20.0)
    elif "--robot=adam" in argv:
        from bilevel_gait_gen_tpu.models import adam as robot_mod
        model = robot_mod.make_adam()
        q0_np = np.asarray(robot_mod.stand_config(), np.float64)
        cfg = MPCConfig(num_ee=2, ipm_iters=18, friction_coef=0.3,
                        contact_snap_window=0.07, phase_duration=0.3,
                        force_bound=250.0, swing_height=0.08,
                        force_carrier=True, double_support=0.1,
                        carrier_ramp=0.1, ee_box_size=(0.3, 0.3),
                        raibert=True, raibert_vel_gain=(2.5, 1.0),
                        raibert_hip_scale=(0.0, 1.0),
                        q_diag=(600.0, 600.0, 8000.0, 8.0, 8.0, 10.0,
                                6000.0, 6000.0, 6000.0, 5.0, 5.0, 5.0),
                        ).validate()
        wb_cfg = jwbqp.WBQPConfig(torque_bound=33.5, kp_joint=400.0,
                                  kd_joint=30.0, friction_coef=0.3,
                                  force_weight=5.0)
        carrot_kw = dict(radius=0.12, vel_carrot=True, v_walk=0.10, ki=0.5,
                         stand_on_arrival=False)
        qj = jnp.asarray(q0_np, jnp.float32)
        for _ in range(3):
            com = jrbd.com_position(model, qj)
            feet = jrbd.ee_positions(model, qj)
            qj = jik.solve_ik(model, qj[0:3], qj[3:7],
                              feet.at[:, 0].set(com[0]), qj, iters=20)
        q0_np = np.asarray(qj, np.float64)
    else:
        model = ja1.make_a1()
        q0_np = np.asarray(ja1.stand_config(), np.float64)
    q0_np = jcl.settled_start(model, q0_np)
    init_vx, push, goal, freq, stretch = 0.0, None, None, 0, 1.0
    for a in argv:
        if a.startswith("--initpush"):
            init_vx = float(a.split("=", 1)[1]) if "=" in a else 1.0
        elif a.startswith("--push"):
            push = (1.0, float(a.split("=", 1)[1]) if "=" in a else 1.0)
        elif a.startswith("--goal="):
            goal = tuple(float(v) for v in a.split("=", 1)[1].split(","))
        elif a.startswith("--gait-opt"):
            freq = int(a.split("=", 1)[1]) if "=" in a else 10
        elif a.startswith("--stretch="):
            stretch = float(a.split("=", 1)[1])
    v0 = np.zeros(model.nv)
    v0[0] = init_vx
    sched = (jgait.make_standing(cfg) if "--gait=standing" in argv
             else jgait.make_trot(cfg))
    # the scripts build the schedule in float32
    bounds = np.asarray(sched.bounds, np.float32) * np.float32(stretch)
    return (model, cfg, wb_cfg, q0_np, v0, bounds, carrot_kw, push, goal,
            freq)


WALKS = {
    "a1": ["--goal=0.3,0.1", "--gait-opt"],
    "a1_push_raibert": ["--config=push", "--raibert", "--push=0.5",
                        "--initpush=0.375", "--gait=standing"],
    "mini_cheetah": ["--robot=mini_cheetah", "--gait-opt=5",
                     "--stretch=1.2"],
    "adam": ["--robot=adam", "--goal=0.4,0"],
}


@pytest.mark.parametrize("argv", WALKS.values(), ids=WALKS.keys())
def test_run_mujoco_walk_configuration_matches_jax(argv):
    c = script("torch_run_mujoco_walk").configure(argv, "cpu")
    (model, cfg, wb_cfg, q0, v0, bounds, carrot_kw, push, goal,
     freq) = jax_walk(argv)
    assert dataclasses.asdict(c["cfg"]) == dataclasses.asdict(cfg)
    assert c["wb_cfg"] == convert.from_wbqp_config(wb_cfg)
    assert c["model"].nq == model.nq and c["model"].parent == model.parent
    assert_rel(c["q0"], q0, 2e-5 if "--robot=adam" in argv else 1e-12,
               "q0")
    np.testing.assert_array_equal(c["v0"], v0)
    assert c["sched"].bounds.dtype == torch.float32
    assert_rel(c["sched"].bounds, bounds, 5e-7, "bounds")
    assert (c["push"], c["goal"], c["gait_opt_freq"]) == (push, goal, freq)
    if goal is None:
        assert c["carrot"] is None
    else:
        assert c["carrot"] == script("torch_run_mujoco_walk").GoalCarrot(
            goal=goal, **carrot_kw)


def test_gait_opt_experiment_configuration_matches_jax():
    seconds, stretches, freq, cfg = script(
        "torch_gait_opt_experiment").configure(["1.5", "--freq=4"])
    assert (seconds, stretches, freq) == (1.5, [1.25, 1.4, 1.6], 4)
    assert script("torch_gait_opt_experiment").configure(
        ["--stretch=1.3"])[:3] == (3.0, [1.3], 10)
    want = MPCConfig(ipm_iters=18, double_support=0.1, force_carrier=True,
                     carrier_ramp=0.1, raibert=True,
                     raibert_vel_gain=(1.8, 1.2)).validate()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


@pytest.mark.parametrize("trot", [False, True], ids=["standing", "trot"])
def test_hardware_sim_demo_setup_matches_jax(trot):
    hsd = script("torch_hardware_sim_demo")
    cfg = MPCConfig(ipm_iters=18, double_support=0.1, force_carrier=True,
                    carrier_ramp=0.1).validate()
    assert dataclasses.asdict(hsd.make_config()) == dataclasses.asdict(cfg)
    q0 = jcl.settled_start(ja1.make_a1(),
                           np.asarray(ja1.stand_config(), np.float64))
    sched = jgait.make_trot(cfg) if trot else jgait.make_standing(cfg)
    assert_start(hsd.setup(hsd.make_config(), trot, "cpu", F64),
                 jax_start(cfg, jnp.asarray(q0), sched))


# ---------------------------------------------------------------------------
# each main, short, in MuJoCo on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def no_files(monkeypatch, tmp_path):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_run_mujoco_walk_main_runs_short(capsys, no_files):
    assert script("torch_run_mujoco_walk").main(["0.3", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "closed loop: 0.3s, robot=a1" in out
    assert "MPC solves: 6 (avg" in out and "fails: 0" in out
    assert out.rstrip().splitlines()[-2] == "WALKED"
    assert (no_files / "walk_rollout.png").stat().st_size > 1000
    assert np.load(no_files / "walk_qs.npy").shape == (300, 19)


def test_gait_opt_experiment_main_runs_short(capsys):
    """Both arms 0.3 s on a trot stretched x1.25, the gait update in place
    of every second RTI: 3 gait updates in the gait-on arm."""
    assert script("torch_gait_opt_experiment").main(
        ["0.3", "--cpu", "--stretch=1.25", "--freq=2"]) == 0
    out = capsys.readouterr().out
    assert "[x1.25] gait-off:" in out and "solves 6 (fails 0)" in out
    on = [ln for ln in out.splitlines() if "gait-on:" in ln]
    assert len(on) == 1 and "UPRIGHT" in on[0]
    accepts = int(on[0].split("accepts ")[1].split(")")[0])
    assert 1 <= accepts <= 3
    assert "[x1.25] WIN" in out
    assert out.rstrip().splitlines()[-1] == "GAIT-OPT WINS (1/1 scenarios)"


def test_hardware_sim_demo_main_runs_short(capsys):
    assert script("torch_hardware_sim_demo").main(
        ["0.3", "--cpu", "--trot"]) == 0
    out = capsys.readouterr().out
    assert "running 300 ticks over loopback UDP ..." in out
    assert "MPC solves 6 (fails 0)" in out
    assert out.rstrip().splitlines()[-1] == "UPRIGHT"
