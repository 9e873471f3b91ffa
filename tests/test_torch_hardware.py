"""The port's hardware stack (``control/unitree_wire.py``,
``control/hardware.py``) against the JAX package's, on inputs made with a
numpy seed.

* the wire: Unitree LowCmd / LowState frames, their CRC and the NatNet
  mocap frames, and HardwareRobot's own state / command packets, byte for
  byte; each package decodes the other's bytes;
* the host components: the state estimator over a seeded sequence (both
  packages' low-pass banks), the torque check, the gain schedule and the
  Stand ramp with its fall-back, as tests/test_hardware.py checks them, the
  port's results equal to the JAX package's;
* ``HardwareRobot.step_once`` with one numpy control_fn in both packages:
  the command bytes equal;
* the slice as a whole, float64, N=10: both packages' HardwareRobot fed the
  same scripted state packets (the settled stand with seeded joint noise, a
  mocap update every 4th tick) for two MPC periods and the first ticks of
  the third, whose MPC update is the gait update (``gait_opt_every=2``).
  The port's control_fn is chip_smoke.HardwareMPC (phase 12's, eager on
  the CPU); the JAX package's is scripts/hardware_sim_demo.py's with the
  JAX ``bilevel.gait_opt_update`` on the gait update, as
  ``sim/engine.closed_loop`` makes it.  The decoded commands match tick by
  tick within 1e-6 of each field's largest magnitude, as
  tests/test_torch_families.py holds the cadence.

Every UDP endpoint binds port 0 (``runtime.loopback_pair``); the JAX
package's HardwareRobot takes the port's endpoints, whose send and recv are
its own endpoint's.
"""
import dataclasses
import struct
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.control import hardware as jhw
from bilevel_gait_gen_tpu.control import mpc_controller as jmpc
from bilevel_gait_gen_tpu.control import unitree_wire as juw
from bilevel_gait_gen_tpu.control import wbqp as jwbqp
from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import bilevel as jbilevel, gait as jgait
from bilevel_gait_gen_tpu.mpc import solver as jsolver
from bilevel_gait_gen_tpu.mpc.gait import GaitSchedule as JSched
from bilevel_gait_gen_tpu.mpc.trajectory import Trajectory as JTraj
from bilevel_gait_gen_tpu.ops import pdip as jpdip
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert, runtime
from bilevel_gait_gen_tpu_torch.control import hardware as hw
from bilevel_gait_gen_tpu_torch.control import unitree_wire as uw
from bilevel_gait_gen_tpu_torch.sim.engine import SimConfig
from test_torch_runtime import jax_runtime, recv_within

import chip_smoke

torch.set_num_threads(2)

NJ = 12
QUAT = np.array([0.0, 0.0, 0.0, 1.0])


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _cmds(seed):
    rng = np.random.default_rng(seed)
    fields = dict(q=rng.normal(size=20), dq=rng.normal(size=20),
                  tau=rng.normal(size=20), kp=np.abs(rng.normal(size=20)),
                  kd=np.abs(rng.normal(size=20)))
    extra = dict(mode=0x0A, sn=int(rng.integers(0, 2 ** 31)),
                 robot_id=int(rng.integers(0, 2 ** 16)))
    return uw.LowCmd(**fields, **extra), juw.LowCmd(**fields, **extra)


def _states(seed):
    rng = np.random.default_rng(seed)
    fields = dict(q=rng.normal(size=20), dq=rng.normal(size=20),
                  tau_est=rng.normal(size=20), quat=rng.normal(size=4),
                  gyro=rng.normal(size=3), accel=rng.normal(size=3),
                  rpy=rng.normal(size=3),
                  foot_force=rng.integers(-500, 500, size=4),
                  tick=int(rng.integers(0, 2 ** 32)))
    return uw.LowState(**fields), juw.LowState(**fields)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unitree_frames_and_crc_are_the_jax_packages_bytes(seed):
    cmd, jcmd = _cmds(seed)
    buf = uw.encode_low_cmd(cmd)
    assert buf == juw.encode_low_cmd(jcmd)
    assert len(buf) == uw.LOW_CMD_SIZE == juw.LOW_CMD_SIZE
    a, b = uw.decode_low_cmd(buf), juw.decode_low_cmd(buf)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      f.name)
    st, jst = _states(seed)
    sbuf = uw.encode_low_state(st)
    assert sbuf == juw.encode_low_state(jst)
    a, b = uw.decode_low_state(sbuf), juw.decode_low_state(sbuf)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      f.name)
    words = np.random.default_rng(seed).integers(0, 2 ** 32, size=37,
                                                 dtype=np.uint32)
    assert uw.crc32_core(words) == juw.crc32_core(words)
    # a flipped bit is refused by both decoders
    bad = bytearray(sbuf)
    bad[100] ^= 0x10
    for decode in (uw.decode_low_state, juw.decode_low_state):
        with pytest.raises(ValueError, match="CRC"):
            decode(bytes(bad))


def test_mocap_frames_are_the_jax_packages_bytes():
    rng = np.random.default_rng(3)
    pos, quat = rng.normal(size=(3, 3)), rng.normal(size=(3, 4))
    ours = uw.encode_mocap_frame(17, [uw.RigidBody(i, pos[i], quat[i])
                                      for i in range(3)])
    theirs = juw.encode_mocap_frame(17, [juw.RigidBody(i, pos[i], quat[i])
                                         for i in range(3)])
    assert ours == theirs
    (fa, ba), (fb, bb) = uw.decode_mocap_frame(ours), \
        juw.decode_mocap_frame(ours)
    assert fa == fb == 17
    for x, y in zip(ba, bb):
        assert x.body_id == y.body_id
        np.testing.assert_array_equal(x.pos, y.pos)
        np.testing.assert_array_equal(x.quat, y.quat)
    assert uw.decode_mocap_frame(b"\x00\x01") is None
    assert uw.decode_mocap_frame(theirs[:10]) is None


def test_hardware_packets_are_the_jax_packages_bytes():
    rng = np.random.default_rng(4)
    q, dq, tau, kp, kd = rng.standard_normal((5, NJ))
    assert hw.pack_command(9, q, dq, kp, kd, tau) == jhw.pack_command(
        9, q, dq, kp, kd, tau)
    quat, gyro, acc = rng.standard_normal(4), rng.standard_normal(3), \
        rng.standard_normal(3)
    pkt = hw.pack_state(7, q, dq, tau, quat, gyro, acc)
    assert pkt == jhw.pack_state(7, q, dq, tau, quat, gyro, acc)
    for a, b in zip(hw.unpack_state(pkt, NJ), jhw.unpack_state(pkt, NJ)):
        np.testing.assert_array_equal(a, b)
    assert hw.unpack_state(b"\x00" * 64, NJ) is None
    assert (hw.MAGIC, hw.KIND_STATE, hw.KIND_COMMAND) == (
        jhw.MAGIC, jhw.KIND_STATE, jhw.KIND_COMMAND)


# ---------------------------------------------------------------------------
# the host components
# ---------------------------------------------------------------------------

def test_state_estimators_agree_over_a_seeded_sequence():
    """Mocap updates at 240 Hz (positions of a seeded random walk), joint
    velocities and ground forces at the control rate: the port's estimator
    (its own runtime's filters) gives the JAX package's values bit for
    bit."""
    jax_runtime()
    cfg = dict(control_hz=1000.0, vcom_cutoff=25.0)
    ours = hw.StateEstimator(NJ, hw.EstimatorConfig(**cfg))
    theirs = jhw.StateEstimator(NJ, jhw.EstimatorConfig(**cfg))
    rng = np.random.default_rng(5)
    pos = np.cumsum(0.001 * rng.standard_normal((120, 3)), axis=0)
    for k in range(120):
        t = k / 240.0
        np.testing.assert_array_equal(ours.mocap_update(pos[k], t),
                                      theirs.mocap_update(pos[k], t))
        dq, grf = rng.standard_normal(NJ), rng.standard_normal(12)
        np.testing.assert_array_equal(ours.joint_velocities(dq),
                                      theirs.joint_velocities(dq))
        np.testing.assert_array_equal(ours.grf_update(grf),
                                      theirs.grf_update(grf))
        np.testing.assert_array_equal(ours.acom, theirs.acom)
        np.testing.assert_array_equal(ours.vcom, theirs.vcom)
    # constant velocity converges (tests/test_hardware.py)
    est = hw.StateEstimator(NJ, hw.EstimatorConfig())
    v_true = np.array([0.5, -0.2, 0.0])
    for k in range(500):
        est.mocap_update(v_true * k / 240.0, k / 240.0)
    np.testing.assert_allclose(est.vcom, v_true, atol=1e-3)


def test_verify_torques_and_gain_schedule_match_jax():
    tau = np.array([1.0, np.nan, 50.0, -np.inf, -40.0, 33.5])
    out = hw.verify_torques(tau, 33.5)
    np.testing.assert_array_equal(out, jhw.verify_torques(tau, 33.5))
    np.testing.assert_allclose(out, [1.0, 0.0, 33.5, 0.0, -33.5, 33.5])
    rng = np.random.default_rng(6)
    for _ in range(4):
        contact = rng.random(4) < 0.5
        for a, b in zip(hw.GainSchedule().gains(contact),
                        jhw.GainSchedule().gains(contact)):
            np.testing.assert_array_equal(a, b)
    kp, kd = hw.GainSchedule().gains(np.array([True, False, True, False]))
    assert kp.shape == (12,) and kp[0] == 35.0 and kp[3] == 60.0


class _Pair:
    """Both packages' HardwareRobot, each on its own loopback pair."""

    def __init__(self, make_fn, **kw):
        jax_runtime()
        self.links = [runtime.loopback_pair() for _ in range(2)]
        self.bots = [pkg.HardwareRobot(NJ, link[0], make_fn(), **kw)
                     for pkg, link in zip((hw, jhw), self.links)]

    def set_mode(self, mode):
        for pkg, bot in zip((hw, jhw), self.bots):
            bot.set_mode(pkg.Mode[mode])

    def tick(self, t, pkt):
        """Both robots fed ``pkt`` at time t: their command bytes."""
        out = []
        for (ctrl_ep, robot_ep), bot in zip(self.links, self.bots):
            robot_ep.send(pkt)
            t_end = time.monotonic() + 2.0
            while not bot.step_once(t):
                assert time.monotonic() < t_end, "the state packet"
            cmd = recv_within(robot_ep)
            assert cmd is not None, "the command packet"
            out.append(cmd)
        return out


def test_step_once_sends_the_jax_packages_command_bytes():
    rng = np.random.default_rng(7)

    def make_fn():
        def control_fn(q, dq, quat, gyro, vcom, t, mode):
            tau = 40.0 * np.sin(q + t) + dq      # some beyond the limit
            return tau, q + 0.1, -dq, (q[::3] > 0.0)
        return control_fn

    pair = _Pair(make_fn)
    pair.set_mode("MPC")
    for k in range(20):
        pkt = jhw.pack_state(k, *rng.standard_normal((3, NJ)), QUAT,
                             rng.standard_normal(3), rng.standard_normal(3))
        ours, theirs = pair.tick(0.001 * k, pkt)
        assert ours == theirs, k
    magic, kind, seq = struct.unpack_from("<HHI", ours, 0)
    assert (magic, kind, seq) == (hw.MAGIC, hw.KIND_COMMAND, 20)


def test_stand_ramp_and_fall_back_match_jax():
    """The Stand ramp from the captured configuration to the stand
    configuration over stand_time, and a raising control_fn in Mode.MPC
    falling back to Stand (tests/test_hardware.py), in both packages."""
    q_stand = np.linspace(0.1, 1.2, NJ)

    def make_fn():
        def failing(*args):
            raise RuntimeError("solver rejected")
        return failing

    pair = _Pair(make_fn, stand_config=q_stand, stand_time=0.5)
    pair.set_mode("STAND")
    pkt = jhw.pack_state(1, np.zeros(NJ), np.zeros(NJ), np.zeros(NJ), QUAT,
                         np.zeros(3), np.zeros(3))
    q_des = []
    for t in (0.25, 0.5, 2.0):
        ours, theirs = pair.tick(t, pkt)
        assert ours == theirs
        q_des.append(np.frombuffer(ours[8:], np.float32).reshape(NJ, 5)[:, 0])
    np.testing.assert_allclose(q_des[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(q_des[1], 0.5 * q_stand, atol=1e-5)
    np.testing.assert_allclose(q_des[2], q_stand, atol=1e-5)
    pair.set_mode("MPC")
    ours, theirs = pair.tick(3.0, pkt)
    assert ours == theirs
    assert [b.mode.name for b in pair.bots] == ["STAND", "STAND"]


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

N = 10
TICKS_PER_S = 1000.0
N_TICKS = 105          # two MPC periods of 50 ticks, then the gait update
                       # and four more ticks
JCFG = MPCConfig(num_nodes=N, ipm_iters=18, double_support=0.1,
                 force_carrier=True, carrier_ramp=0.1).validate()


def _to_jax_state(st):
    """A port SolverState of batch 1 as the JAX package's (one robot)."""
    tr = convert.to_numpy(st.traj)
    warm = None
    if st.qp_warm is not None:
        w = convert.to_numpy(st.qp_warm)
        warm = jpdip.QPSolution(*(jnp.asarray(getattr(w, f)[0]) for f in
                                  jpdip.QPSolution._fields))
    return jsolver.SolverState(
        traj=JTraj(x_man=jnp.asarray(tr.x_man[0]),
                   f_nodes=jnp.asarray(tr.f_nodes[0]),
                   footholds=jnp.asarray(tr.footholds[0]),
                   sched=JSched(bounds=jnp.asarray(tr.sched.bounds[0]))),
        ee_box=jnp.asarray(convert.to_numpy(st.ee_box)[0]), qp_warm=warm)


class _JaxControl:
    """scripts/hardware_sim_demo.py's control_fn with the schedule sync of
    sim/engine.closed_loop and its gait update on every 2nd MPC update."""

    def __init__(self, jm, params, cfg, wb, state, x_des):
        self.cfg, self.state, self.trust = cfg, state, jnp.asarray(
            cfg.trust_region, jnp.float64)
        self.t0, self.n_mpc = 0.0, 0
        self.q_full = self.contact = None

        def prep(st, q, v, t, mc):
            sched = jgait.adjust_for_current_contacts(
                st.traj.sched, mc, t, window=cfg.contact_snap_window)
            st = dataclasses.replace(st, traj=dataclasses.replace(
                st.traj, sched=sched))
            return (st, jmpc.reconstruct_srb_state(jm, params, q, v),
                    jrbd.ee_positions(jm, q))

        def rti(st, trust, q, v, t, mc):
            st, x, feet = prep(st, q, v, t, mc)
            st2, stats = jsolver.solve_step(cfg, params, st, x, t, feet,
                                            x_des)
            return st2, stats, trust

        def gait(st, trust, q, v, t, mc):
            st, x, feet = prep(st, q, v, t, mc)
            res = jbilevel.gait_opt_update(cfg, params, st, x, t, feet,
                                           x_des, trust=trust)
            return res.state, res.rti_stats, res.trust

        self.update = {False: jax.jit(rti), True: jax.jit(gait)}
        self.tick = jax.jit(lambda tr, q, v, t, t0, mc:
                            jmpc.control_action_full(jm, params, cfg, wb, tr,
                                                     q, v, t, t0, mc))

    def __call__(self, q_j, dq, quat, gyro, vcom, t, mode):
        q = jnp.asarray(np.concatenate([self.q_full[0:3], quat, q_j]),
                        jnp.float64)
        v = jnp.asarray(np.concatenate([vcom, gyro, dq]), jnp.float64)
        tt = jnp.asarray(t, jnp.float64)
        mc = jnp.asarray(self.contact)
        if self.n_mpc == 0 or t >= self.t0 + self.cfg.dt:
            gait = self.n_mpc > 0 and self.n_mpc % 2 == 0
            self.state, _, self.trust = self.update[gait](
                self.state, self.trust, q, v, tt, mc)
            self.t0 = t
            self.n_mpc += 1
        out = self.tick(self.state.traj, q, v, tt,
                        jnp.asarray(self.t0, jnp.float64), mc)
        return tuple(np.asarray(a) for a in out)


def test_hardware_robots_send_the_same_commands_through_a_gait_update():
    cfg = convert.from_config(JCFG)
    wb = jwbqp.WBQPConfig()
    model, params, st, q0, x_des = chip_smoke.hardware_start(
        cfg, SimConfig(), "cpu", torch.float64)
    ours = chip_smoke.HardwareMPC(model, params, cfg,
                                  convert.from_wbqp_config(wb), x_des,
                                  gait_opt_every=2)
    jm = ja1.make_a1()
    jparams = jsrb.SRBParams(**{
        f.name: jnp.asarray(convert.to_numpy(getattr(params, f.name)))
        for f in dataclasses.fields(jsrb.SRBParams)})
    theirs = _JaxControl(jm, jparams, JCFG, wb, _to_jax_state(st),
                         jnp.asarray(convert.to_numpy(x_des)[0]))
    q0 = q0.numpy()
    contact = np.ones(4, bool)
    ours.reset(st, q0, np.zeros(18), contact)
    theirs.q_full, theirs.contact = q0, contact
    fns = iter((ours, theirs))
    pair = _Pair(lambda: next(fns), stand_config=q0[7:].copy())
    for pkg, bot in zip((hw, jhw), pair.bots):
        bot.estimator = pkg.StateEstimator(NJ, pkg.EstimatorConfig(
            control_hz=TICKS_PER_S))
    pair.set_mode("MPC")
    rng = np.random.default_rng(8)
    got = []
    for k in range(N_TICKS):
        t = k / TICKS_PER_S
        q_j = q0[7:] + 0.01 * rng.standard_normal(NJ)
        ours.q_full = theirs.q_full = np.concatenate([q0[:7], q_j])
        if k % 4 == 0:
            for bot in pair.bots:
                bot.estimator.mocap_update(q0[0:3].copy(), t)
        pkt = jhw.pack_state(k, q_j, 0.05 * rng.standard_normal(NJ),
                             np.zeros(NJ), q0[3:7],
                             0.01 * rng.standard_normal(3), np.zeros(3))
        cmds = pair.tick(t, pkt)
        assert [b.mode.name for b in pair.bots] == ["MPC", "MPC"], k
        got.append([np.frombuffer(c[8:], np.float32).reshape(NJ, 5)
                    for c in cmds])
    assert [u[0] for u in ours.updates] == ["rti", "rti", "gait"]
    assert theirs.n_mpc == 3 and not ours.errors
    assert all(u[2][-1] == 1.0 for u in ours.updates)
    got = np.asarray(got)                       # [T, 2, NJ, 5]
    port, ref = got[:, 0].astype(np.float64), got[:, 1].astype(np.float64)
    assert np.isfinite(port).all()
    for j, name in enumerate(("q_des", "dq_des", "kp", "kd", "tau_ff")):
        np.testing.assert_allclose(port[..., j], ref[..., j], rtol=0,
                                   atol=1e-6 * np.abs(ref[..., j]).max(),
                                   err_msg=name)
