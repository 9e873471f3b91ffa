"""What ``test_torch_closed_loop.py`` and ``test_torch_closed_loop_carrot.py``
share: one scenario, the JAX package's ``run_closed_loop`` run on it in
MuJoCo with a recording ``MujocoLoop`` in its module's namespace, and the
port's ``ClosedLoopController`` fed the recorded sequence.

The scenario is ``run_push_recovery``'s configuration and settled start
(8 interior-point sweeps in place of 18) at 0.3 m/s with the gait update
every second MPC tick, the flight hold on, a goal carrot 6 cm ahead and a
push of -0.2 m/s at 0.1 s, which brakes the walk: in its 0.22 s at 1 kHz
it runs RTIs, two gait updates (the first accepted, after one airborne
tick), the push, the arrival at 0.162 s and the standing MPC's first RTI.
One JAX run serves both files (:func:`recorded_scenario`).

The recording subclass logs each control call's (q, v, t, contacts) and the
torques the JAX ``control_fn`` returned; t is the time that ``control_fn``
sees (after a push, ``run_closed_loop`` adds the push time to the time of
its second ``MujocoLoop.run``)."""
import dataclasses
import fcntl
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.sim import closed_loop as jcl
from bilevel_gait_gen_tpu.sim.mujoco_bridge import MujocoLoop as JaxLoop
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.control import wbqp as pwbqp
from bilevel_gait_gen_tpu_torch.models import a1
from bilevel_gait_gen_tpu_torch.ops import pdip as ppdip
from bilevel_gait_gen_tpu_torch.sim import closed_loop as pcl

# tolerances of the tick-by-tick comparison (float64, see check_ticks): a
# control tick's torques against the JAX run's, relative to
# max(1, max|tau|), and the share of the ticks where the torque QP stops on
# its sweep cap allowed beyond it; an MPC tick's cost, relative (the
# interior-point stopping tests and the line search amplify the last bits
# of float64: the plans after the initial run are 4.7e-8 apart).  The
# torques track the plan at t - t0, so their gap grows through an MPC
# period: in the scenario from 4e-8 after the RTI at 0.1 s to 1.0e-6 at
# its last tick, after the push
TOL_RUN = 2e-6
MAX_PARTED = 0.05
TOL_COST = 1e-6


# interior-point sweeps of the MPC's QPs in the scenario, in place of
# run_push_recovery's 18: tracing and compiling the JAX package's jitted
# functions is most of these tests' time, and it scales with the unrolled
# sweeps; both packages run the same configuration
TEST_IPM_ITERS = 8

# the scenario (see the module's docstring)
SECONDS = 0.22
INIT_VX = 0.3        # m/s
GAIT_FREQ = 2
GOAL = (0.06, 0.0)   # m, from the start
PUSH = (0.1, -0.2)   # (s, m/s) added to the base's forward velocity


def push_recovery_args(**overrides):
    """The arguments that the JAX package's ``run_push_recovery`` hands to
    ``run_closed_loop`` (its config, model and settled start), captured by
    a stand-in: (args, kwargs)."""
    got = {}

    def capture(*args, **kw):
        got["args"], got["kw"] = args, kw

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "run_closed_loop", capture)
        jcl.run_push_recovery(dtype=jnp.float64, **overrides)
    return got["args"], got["kw"]


def scenario_args(**overrides):
    """``push_recovery_args`` with TEST_IPM_ITERS sweeps: (model, cfg,
    wb_cfg, q0, v0, the controller's keyword arguments but dtype)."""
    (model, cfg, wb, q0, v0, _), kw = push_recovery_args(**overrides)
    kw.pop("dtype")
    cfg = dataclasses.replace(cfg, ipm_iters=TEST_IPM_ITERS).validate()
    return model, cfg, wb, q0, v0, kw


def scenario_kwargs():
    """``run_closed_loop``'s arguments for the scenario: (model, cfg,
    wb_cfg, q0, v0, keyword arguments but dtype, the carrot and the push)."""
    return scenario_args(init_vx=INIT_VX, gait_opt_freq=GAIT_FREQ)


def recorded_scenario(tmp_path_factory):
    """The JAX package's float64 run of the scenario with the recording
    loop: (model, cfg, wb_cfg, q0, v0, keyword arguments, its
    ClosedLoopResult, list of (q, v, t, contacts, tau)).  The first test
    process to ask runs it and leaves it in a directory that the test
    workers of one run share; the others wait on a lock there and read it."""
    model, cfg, wb, q0, v0, kw = scenario_kwargs()
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    with open(root / "jax_closed_loop.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            path = root / "jax_closed_loop.pkl"
            if path.exists():
                with open(path, "rb") as f:
                    res, rec = pickle.load(f)
            else:
                res, rec = _recorded_jax_run(
                    model, cfg, wb, q0, v0, SECONDS, PUSH,
                    carrot=jcl.GoalCarrot(goal=GOAL), **kw)
                res = res._replace(final_state=None)
                with open(path, "wb") as f:
                    pickle.dump((res, rec), f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return model, cfg, wb, q0, v0, kw, res, rec


def _recorded_jax_run(model, cfg, wb, q0, v0, seconds, push, **kw):
    rec = []
    offsets = [0.0, push[0] if push else 0.0]

    class RecordingLoop(JaxLoop):
        runs = 0

        def run(self, control_fn, n_steps, **run_kw):
            off = offsets[min(RecordingLoop.runs, 1)]
            RecordingLoop.runs += 1

            def fn(q, v, t):
                mc = self.contacts()
                tau = np.asarray(control_fn(q, v, t))
                rec.append((q.copy(), v.copy(), t + off, mc.copy(),
                            tau.copy()))
                return tau
            return super().run(fn, n_steps, **run_kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "MujocoLoop", RecordingLoop)
        res = jcl.run_closed_loop(model, cfg, wb, q0, v0, seconds, push=push,
                                  dtype=jnp.float64, **kw)
    return res, rec


def port_controller(cfg, wb, q0, v0, **kw):
    """The port's controller on the CPU in float64 for the JAX run's
    configuration and the scenario's carrot (``kw``: run_closed_loop's
    controller arguments)."""
    return pcl.ClosedLoopController(
        a1.make_a1(device="cpu"), convert.from_config(cfg),
        convert.from_wbqp_config(wb), q0, v0,
        carrot=pcl.GoalCarrot(goal=GOAL), device="cpu",
        dtype=torch.float64, **kw)


def replay(ctl, rec):
    """Feed ``rec`` to the port's controller ``ctl``: (the port's torques
    [T, nj], whether the port's torque QP stopped on its tolerance before
    its last sweep at each tick [T])."""
    solved = []

    class Watch:
        def __getattr__(self, name):
            return getattr(ppdip, name)

        def solve(self, *args, **kw):
            sol = ppdip.solve(*args, **kw)
            solved.append(bool(sol.iters[0] < kw["iters"]))
            return sol

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pwbqp, "pdip", Watch())
        taus = [ctl(q, v, t, mc) for q, v, t, mc, _ in rec]
    return np.stack(taus), np.asarray(solved)


def tick_distances(taus, rec):
    """Each tick's max|tau_port - tau_jax| relative to max(1, max|tau|)
    over the JAX run's recorded torques."""
    rec_tau = np.stack([r[4] for r in rec])
    scale = np.maximum(1.0, np.abs(rec_tau).max(1))
    return np.abs(taus - rec_tau).max(1) / scale


def check_converged_ticks(d, solved, ticks):
    """Where the port's torque QP stops on its tolerance (``solved``), the
    ticks ``ticks`` within TOL_RUN of the JAX run: its jitted closures fold
    the model's float32 mass sum one ulp away from the eager sum that the
    port and the JAX package's SRB parameters hold (~5e-7 N m of carrier
    force)."""
    k = np.arange(len(d))[ticks]
    k = k[solved[k]]
    assert np.all(d[k] <= TOL_RUN), [(int(i), d[i]) for i in k
                                     if d[i] > TOL_RUN]


def check_capped_ticks(d, solved):
    """Where the torque QP stops on its sweep cap, it returns its iterate
    after ``ipm_iters`` sweeps (the JAX package's as the port's; about half
    the ticks of a trot), which the last bits of its inputs move: all but
    MAX_PARTED of those ticks within TOL_RUN.  Returns (ticks solved,
    ticks capped)."""
    parted = np.flatnonzero(~solved & (d > TOL_RUN))
    assert parted.size <= MAX_PARTED * (~solved).sum(), [
        (int(k), d[k]) for k in parted]
    return int(solved.sum()), int((~solved).sum())
