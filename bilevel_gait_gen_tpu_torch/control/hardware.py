"""Hardware deployment layer: robot driver, state estimation, state machine
(port of ``bilevel_gait_gen_tpu/control/hardware.py``; numpy on the host,
over the port's own native runtime, ``bilevel_gait_gen_tpu_torch.runtime``).

Replaces hardware::HardwareRobot + hardware_interface
(hardware/hardware_robot.cpp, hardware/hardware_interface.cpp): a control
callback that receives motor state over UDP, fuses an external mocap pose,
low-pass filters the velocity/force estimates, runs a {Hold, Stand, MPC,
Testing} state machine, sanity-checks torques, and sends motor commands
back.  Built on the native runtime primitives (rate loop, LPF bank, UDP,
triple buffer); an MPC solver running in a separate thread publishes
trajectories through the wait-free triple buffer.

The wire format is a simple versioned binary frame, the JAX package's byte
for byte (the reference links the proprietary Unitree SDK; see
``unitree_wire`` for that protocol's frames).
"""
from __future__ import annotations

import dataclasses
import enum
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np

from bilevel_gait_gen_tpu_torch import runtime
from bilevel_gait_gen_tpu_torch.utils import lowlevel_log


class Mode(enum.Enum):
    """Operating modes (reference hardware_robot.h:46-51)."""
    HOLD = 0
    STAND = 1
    MPC = 2
    TESTING = 3


# Wire format: little-endian, header u16 magic, u16 kind, u32 seq, payload
MAGIC = 0xB661
KIND_STATE = 1     # robot -> host: nj*(q, dq, tau_est) + imu quat + gyro + acc
KIND_COMMAND = 2   # host -> robot: nj*(q_des, dq_des, kp, kd, tau_ff)


def pack_command(seq: int, q_des, dq_des, kp, kd, tau_ff) -> bytes:
    nj = len(q_des)
    payload = np.stack([q_des, dq_des, kp, kd, tau_ff]).astype(
        np.float32).T.reshape(-1)
    return struct.pack("<HHI", MAGIC, KIND_COMMAND, seq) + payload.tobytes()


def unpack_state(data: bytes, nj: int):
    magic, kind, seq = struct.unpack_from("<HHI", data, 0)
    if magic != MAGIC or kind != KIND_STATE:
        return None
    arr = np.frombuffer(data, dtype=np.float32, offset=8)
    q = arr[0:nj]
    dq = arr[nj:2 * nj]
    tau = arr[2 * nj:3 * nj]
    quat = arr[3 * nj:3 * nj + 4]          # xyzw
    gyro = arr[3 * nj + 4:3 * nj + 7]
    acc = arr[3 * nj + 7:3 * nj + 10]
    return seq, q, dq, tau, quat, gyro, acc


def pack_state(seq: int, q, dq, tau, quat, gyro, acc) -> bytes:
    payload = np.concatenate([q, dq, tau, quat, gyro, acc]).astype(np.float32)
    return struct.pack("<HHI", MAGIC, KIND_STATE, seq) + payload.tobytes()


@dataclasses.dataclass
class EstimatorConfig:
    """LPF cutoffs (reference hardware_robot.cpp:153-180: v_com 20 Hz @240,
    a_com 15 Hz @2000, v_joints 100 Hz @2000, grf 50 Hz @2000)."""
    control_hz: float = 2000.0
    mocap_hz: float = 240.0
    vcom_cutoff: float = 20.0
    acom_cutoff: float = 15.0
    vjoint_cutoff: float = 100.0
    grf_cutoff: float = 50.0


class StateEstimator:
    """COM state from mocap + finite differences + LPF chains
    (ComputeCOMStateEstimate, hardware_robot.cpp:503+)."""

    def __init__(self, nj: int, cfg: EstimatorConfig, num_ee: int = 4):
        self.cfg = cfg
        self.vcom_f = runtime.LowPassBank(3, cfg.vcom_cutoff, cfg.mocap_hz)
        self.acom_f = runtime.LowPassBank(3, cfg.acom_cutoff, cfg.control_hz)
        self.vj_f = runtime.LowPassBank(nj, cfg.vjoint_cutoff, cfg.control_hz)
        # GRF chain (reference filters the per-foot force estimate at 50 Hz,
        # hardware_robot.cpp:176-180); fed by grf_update with the raw J^T-tau
        # estimate from whoever owns the model
        self.grf_f = runtime.LowPassBank(3 * num_ee, cfg.grf_cutoff,
                                         cfg.control_hz)
        self._last_pos: Optional[np.ndarray] = None
        self._last_t: Optional[float] = None
        self._vcom = np.zeros(3)
        self._last_vcom: Optional[np.ndarray] = None
        self._last_vcom_t: Optional[float] = None
        self._acom = np.zeros(3)
        self._grf = np.zeros(3 * num_ee)

    def mocap_update(self, pos: np.ndarray, t: float) -> np.ndarray:
        if self._last_pos is not None and t > self._last_t:
            v = (pos - self._last_pos) / (t - self._last_t)
            self._vcom = self.vcom_f.step(v)
            # a_com from the filtered velocity (reference LPF chain at
            # 15 Hz, hardware_robot.cpp:160-166)
            if self._last_vcom is not None:
                a = (self._vcom - self._last_vcom) / (t - self._last_vcom_t)
                self._acom = self.acom_f.step(a)
            self._last_vcom = self._vcom.copy()
            self._last_vcom_t = t
        self._last_pos = pos.copy()
        self._last_t = t
        return self._vcom

    def joint_velocities(self, dq_raw: np.ndarray) -> np.ndarray:
        return self.vj_f.step(dq_raw)

    def grf_update(self, grf_raw: np.ndarray) -> np.ndarray:
        """Filter a raw per-foot ground-reaction-force estimate [3E]."""
        self._grf = self.grf_f.step(np.asarray(grf_raw, np.float64))
        return self._grf

    @property
    def vcom(self) -> np.ndarray:
        return self._vcom

    @property
    def acom(self) -> np.ndarray:
        return self._acom

    @property
    def grf(self) -> np.ndarray:
        return self._grf


def verify_torques(tau: np.ndarray, limit: float) -> np.ndarray:
    """Torque sanity check: clamp and zero non-finite commands
    (VerifyControlAction, hardware_robot.cpp:448)."""
    tau = np.where(np.isfinite(tau), tau, 0.0)
    return np.clip(tau, -limit, limit)


@dataclasses.dataclass
class GainSchedule:
    """Per-joint gain schedule with swing/stance switch
    (AssignMPCGains, hardware_robot.cpp:683+)."""
    kp_stance: float = 35.0
    kd_stance: float = 1.0
    kp_swing: float = 60.0
    kd_swing: float = 2.0

    def gains(self, contact: np.ndarray, joints_per_leg: int = 3):
        kp = np.where(np.repeat(contact, joints_per_leg),
                      self.kp_stance, self.kp_swing)
        kd = np.where(np.repeat(contact, joints_per_leg),
                      self.kd_stance, self.kd_swing)
        return kp, kd


class HardwareRobot:
    """2 kHz control loop skeleton (reference ControlCallback flow).

    control_fn(q_j, dq, quat, gyro, vcom, t, mode) -> (tau, q_des, dq_des,
    contact) runs the controller; an MPC thread publishes trajectory snapshots
    through `traj_buffer`, exactly replacing the reference's mutexed
    producer/consumer pair (mpc_controller.h:99-103).
    """

    def __init__(self, nj: int, udp: "runtime.UdpEndpoint",
                 control_fn: Callable, est_cfg: EstimatorConfig = None,
                 torque_limit: float = 33.5,
                 traj_buffer_size: int = 0,
                 stand_config: Optional[np.ndarray] = None,
                 stand_time: float = 0.5,
                 kp_stand: float = 35.0, kd_stand: float = 1.0,
                 log_path: Optional[str] = None,
                 log_decimation: int = 10):
        self.nj = nj
        self.udp = udp
        self.control_fn = control_fn
        self.estimator = StateEstimator(nj, est_cfg or EstimatorConfig())
        self.torque_limit = torque_limit
        self.mode = Mode.HOLD
        self.gains = GainSchedule()
        self.traj_buffer = (runtime.TripleBuffer(traj_buffer_size)
                            if traj_buffer_size else None)
        # Stand ramp (reference hardware_robot.cpp:190-199: linear
        # interpolation from the config captured at mode entry to the
        # standing config over standing_time)
        self.stand_config = stand_config
        self.stand_time = stand_time
        self.kp_stand = kp_stand
        self.kd_stand = kd_stand
        self._stand_start_t: Optional[float] = None
        self._stand_start_q: Optional[np.ndarray] = None
        self._stop = threading.Event()
        self._seq = 0
        self.overruns = 0
        self.ticks = 0
        # decimated per-tick state/command log (reference's three decimated
        # hardware log files at state_record_pattern,
        # hardware_robot.cpp:183-186)
        self.log = None
        if log_path is not None:
            self.log = lowlevel_log.LowLevelLog(
                log_path,
                fields=[("t", 1), ("q", nj), ("dq", nj), ("tau", nj),
                        ("mode", 1)],
                decimation=log_decimation)

    def set_mode(self, mode: Mode):
        """Interactive mode switch (reference hardware_interface.cpp:153-176
        REPL).  Leaving Stand resets the ramp (reference :418-419)."""
        if mode != Mode.STAND:
            self._stand_start_t = None
            self._stand_start_q = None
        self.mode = mode

    def step_once(self, t: float) -> bool:
        """One control tick: recv -> estimate -> control -> send."""
        pkt = self.udp.recv(4096)
        if pkt is None:
            return False
        parsed = unpack_state(pkt, self.nj)
        if parsed is None:
            return False
        seq, q_j, dq_raw, tau_est, quat, gyro, acc = parsed
        dq = self.estimator.joint_velocities(dq_raw)

        if self.mode == Mode.HOLD:
            tau = np.zeros(self.nj)
            kp = np.zeros(self.nj)
            kd = np.full(self.nj, 2.0)
            q_des, dq_des = q_j, np.zeros(self.nj)
        elif self.mode == Mode.STAND and self.stand_config is not None:
            # linear ramp captured-config -> stand config over stand_time
            # (reference hardware_robot.cpp:190-199)
            if self._stand_start_t is None:
                self._stand_start_t = t
                self._stand_start_q = q_j.copy()
            ratio = min(1.0, (t - self._stand_start_t) / self.stand_time)
            q_des = (self._stand_start_q
                     + ratio * (self.stand_config - self._stand_start_q))
            dq_des = np.zeros(self.nj)
            tau = np.zeros(self.nj)
            kp = np.full(self.nj, self.kp_stand)
            kd = np.full(self.nj, self.kd_stand)
        else:
            try:
                tau, q_des, dq_des, contact = self.control_fn(
                    q_j, dq, quat, gyro, self.estimator.vcom, t, self.mode)
            except Exception:
                # rejected control action: fall back to Stand (reference
                # hardware_robot.cpp:281-292)
                self.set_mode(Mode.STAND)
                tau = np.zeros(self.nj)
                kp = np.full(self.nj, self.kp_stand)
                kd = np.full(self.nj, self.kd_stand)
                q_des, dq_des = q_j, np.zeros(self.nj)
                self._seq += 1
                self.udp.send(pack_command(self._seq, q_des, dq_des, kp,
                                           kd, tau))
                return True
            tau = verify_torques(np.asarray(tau), self.torque_limit)
            kp, kd = self.gains.gains(np.asarray(contact))

        self._seq += 1
        self.udp.send(pack_command(self._seq, q_des, dq_des, kp, kd, tau))
        if self.log is not None:
            self.log.record(t=np.asarray([t]), q=q_j, dq=dq, tau=tau,
                            mode=np.asarray([float(self.mode.value)]))
        return True

    def run(self, duration_s: float, rate_hz: float = 2000.0):
        """Blocking rate-clocked loop (reference LoopFunc at dt=0.5 ms)."""
        rl = runtime.RateLoop(1.0 / rate_hz)
        t0 = time.monotonic()
        while not self._stop.is_set():
            t = time.monotonic() - t0
            if t >= duration_s:
                break
            self.step_once(t)
            rl.wait()
            self.ticks = rl.ticks
            self.overruns = rl.overruns

    def stop(self):
        self._stop.set()
        if self.log is not None:
            self.log.close()
            self.log = None
