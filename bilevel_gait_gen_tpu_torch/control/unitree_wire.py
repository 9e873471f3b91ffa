"""Unitree A1 low-level wire codec + NatNet-style mocap parser (port of
``bilevel_gait_gen_tpu/control/unitree_wire.py``; numpy and struct, no
torch: the bytes are the JAX package's).

The reference links the prebuilt Unitree legged SDK and an OptiTrack
stream client (hardware/unitree_lib/comm.h packet layouts,
hardware/unitree_lib/udp.h:20-44 "User defined data should add crc(4Byte)
at the end", hardware/hardware_robot.cpp:479-501 OptiTrack thread); this
module speaks the same byte layouts from Python, so that the deployment
stack can drive a real A1 (or a byte-faithful simulator) without the
vendor library.

Layouts are `#pragma pack(1)` little-endian structs (comm.h):

    IMU        = 4f quat(wxyz) + 3f gyro + 3f accel + 3f rpy + i8 temp  (53 B)
    MotorState = u8 mode + 7f (q dq ddq tauEst q_raw dq_raw ddq_raw)
                 + i8 temp + 2u32 reserve                               (38 B)
    MotorCmd   = u8 mode + 5f (q dq tau Kp Kd) + 3u32 reserve           (33 B)
    LowState   = hdr(10) + IMU + 20*MotorState + 4i16 footForce
                 + 4i16 footForceEst + u32 tick + 40B remote
                 + u32 reserve + u32 crc                               (891 B)
    LowCmd     = hdr(10) + 20*MotorCmd + 4*LED(3) + 40B remote
                 + u32 reserve + u32 crc                               (730 B)

CRC: the SDK's word-wise bitwise CRC-32 (polynomial 0x04c11db7, init
0xFFFFFFFF, no reflection, no final xor) over the first
(sizeof(struct) >> 2) - 1 little-endian u32 words — the published
convention from Unitree's open examples (`crc32_core`).  The struct sizes
are not multiples of 4, so the trailing (size % 4) bytes before the crc
are NOT covered — faithfully reproduced here.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

LOWLEVEL = 0xFF                     # comm.h levelFlag for low-level control
NUM_MOTORS = 20                     # comm.h motorState[20]/motorCmd[20]
POS_STOP_F = 2.146e9                # comm.h PosStopF (disable position loop)
VEL_STOP_F = 16000.0                # comm.h VelStopF (disable velocity loop)

_IMU_FMT = "<4f3f3f3fb"             # 53 bytes
_MOTOR_STATE_FMT = "<B7fb2I"        # 38 bytes
_MOTOR_CMD_FMT = "<B5f3I"           # 33 bytes
_HDR_FMT = "<BHHIB"                 # levelFlag commVersion robotID SN bandWidth
_IMU_SIZE = struct.calcsize(_IMU_FMT)
_MS_SIZE = struct.calcsize(_MOTOR_STATE_FMT)
_MC_SIZE = struct.calcsize(_MOTOR_CMD_FMT)
_HDR_SIZE = struct.calcsize(_HDR_FMT)

LOW_STATE_SIZE = (_HDR_SIZE + _IMU_SIZE + NUM_MOTORS * _MS_SIZE
                  + 4 * 2 + 4 * 2 + 4 + 40 + 4 + 4)           # 891
LOW_CMD_SIZE = _HDR_SIZE + NUM_MOTORS * _MC_SIZE + 4 * 3 + 40 + 4 + 4  # 730


def crc32_core(words: np.ndarray) -> int:
    """Unitree's word-wise bitwise CRC-32 (poly 0x04c11db7, init
    0xFFFFFFFF, MSB-first data bits, no reflection / final xor)."""
    crc = 0xFFFFFFFF
    poly = 0x04C11DB7
    for data in np.asarray(words, dtype=np.uint32):
        data = int(data)
        xbit = 1 << 31
        for _ in range(32):
            if crc & 0x80000000:
                crc = ((crc << 1) ^ poly) & 0xFFFFFFFF
            else:
                crc = (crc << 1) & 0xFFFFFFFF
            if data & xbit:
                crc ^= poly
            xbit >>= 1
    return crc


def _crc_of(buf: bytes, total_size: int) -> int:
    """CRC over the first (total_size >> 2) - 1 u32 words (SDK convention:
    crc32_core((uint32_t*)&msg, (sizeof(msg)>>2)-1))."""
    n_words = (total_size >> 2) - 1
    words = np.frombuffer(buf[:4 * n_words], dtype="<u4")
    return crc32_core(words)


@dataclasses.dataclass
class LowCmd:
    """Host -> robot low-level command (comm.h LowCmd)."""
    q: np.ndarray                    # [20] desired joint angle [rad]
    dq: np.ndarray                   # [20] desired joint velocity [rad/s]
    tau: np.ndarray                  # [20] feedforward torque [N m]
    kp: np.ndarray                   # [20]
    kd: np.ndarray                   # [20]
    mode: int = 0x0A                 # servo mode (SDK examples)
    level_flag: int = LOWLEVEL
    comm_version: int = 0
    robot_id: int = 0
    sn: int = 0
    bandwidth: int = 0


@dataclasses.dataclass
class LowState:
    """Robot -> host low-level feedback (comm.h LowState)."""
    q: np.ndarray                    # [20]
    dq: np.ndarray                   # [20]
    tau_est: np.ndarray              # [20]
    quat: np.ndarray                 # [4] (w, x, y, z) — comm.h order
    gyro: np.ndarray                 # [3] rad/s
    accel: np.ndarray                # [3] m/s^2
    rpy: np.ndarray                  # [3] rad
    foot_force: np.ndarray           # [4] int16
    tick: int = 0
    level_flag: int = LOWLEVEL


def encode_low_cmd(cmd: LowCmd) -> bytes:
    """Serialize a LowCmd to the 730-byte wire frame, CRC appended."""
    parts = [struct.pack(_HDR_FMT, cmd.level_flag, cmd.comm_version,
                         cmd.robot_id, cmd.sn, cmd.bandwidth)]
    for i in range(NUM_MOTORS):
        parts.append(struct.pack(
            _MOTOR_CMD_FMT, cmd.mode, float(cmd.q[i]), float(cmd.dq[i]),
            float(cmd.tau[i]), float(cmd.kp[i]), float(cmd.kd[i]), 0, 0, 0))
    parts.append(bytes(4 * 3))      # LEDs
    parts.append(bytes(40))         # wirelessRemote
    parts.append(bytes(4))          # reserve
    body = b"".join(parts)
    crc = _crc_of(body + bytes(4), LOW_CMD_SIZE)
    out = body + struct.pack("<I", crc)
    assert len(out) == LOW_CMD_SIZE
    return out


def decode_low_cmd(buf: bytes, check_crc: bool = True) -> LowCmd:
    if len(buf) != LOW_CMD_SIZE:
        raise ValueError(f"LowCmd frame must be {LOW_CMD_SIZE} B, "
                         f"got {len(buf)}")
    if check_crc:
        (crc,) = struct.unpack_from("<I", buf, LOW_CMD_SIZE - 4)
        if crc != _crc_of(buf, LOW_CMD_SIZE):
            raise ValueError("LowCmd CRC mismatch")
    lf, cv, rid, sn, bw = struct.unpack_from(_HDR_FMT, buf, 0)
    q = np.zeros(NUM_MOTORS)
    dq = np.zeros(NUM_MOTORS)
    tau = np.zeros(NUM_MOTORS)
    kp = np.zeros(NUM_MOTORS)
    kd = np.zeros(NUM_MOTORS)
    mode = 0
    for i in range(NUM_MOTORS):
        off = _HDR_SIZE + i * _MC_SIZE
        mode, q[i], dq[i], tau[i], kp[i], kd[i], _, _, _ = \
            struct.unpack_from(_MOTOR_CMD_FMT, buf, off)
    return LowCmd(q=q, dq=dq, tau=tau, kp=kp, kd=kd, mode=mode,
                  level_flag=lf, comm_version=cv, robot_id=rid, sn=sn,
                  bandwidth=bw)


def encode_low_state(st: LowState) -> bytes:
    """Serialize a LowState to the 891-byte wire frame, CRC appended
    (what a byte-faithful robot simulator sends)."""
    parts = [struct.pack(_HDR_FMT, st.level_flag, 0, 0, 0, 0)]
    parts.append(struct.pack(
        _IMU_FMT, *[float(v) for v in st.quat],
        *[float(v) for v in st.gyro], *[float(v) for v in st.accel],
        *[float(v) for v in st.rpy], 0))
    for i in range(NUM_MOTORS):
        parts.append(struct.pack(
            _MOTOR_STATE_FMT, 0x0A, float(st.q[i]), float(st.dq[i]), 0.0,
            float(st.tau_est[i]), float(st.q[i]), float(st.dq[i]), 0.0,
            0, 0, 0))
    parts.append(struct.pack("<4h", *[int(v) for v in st.foot_force]))
    parts.append(struct.pack("<4h", *[int(v) for v in st.foot_force]))
    parts.append(struct.pack("<I", st.tick))
    parts.append(bytes(40))
    parts.append(bytes(4))
    body = b"".join(parts)
    crc = _crc_of(body + bytes(4), LOW_STATE_SIZE)
    out = body + struct.pack("<I", crc)
    assert len(out) == LOW_STATE_SIZE
    return out


def decode_low_state(buf: bytes, check_crc: bool = True) -> LowState:
    if len(buf) != LOW_STATE_SIZE:
        raise ValueError(f"LowState frame must be {LOW_STATE_SIZE} B, "
                         f"got {len(buf)}")
    if check_crc:
        (crc,) = struct.unpack_from("<I", buf, LOW_STATE_SIZE - 4)
        if crc != _crc_of(buf, LOW_STATE_SIZE):
            raise ValueError("LowState CRC mismatch")
    lf, *_ = struct.unpack_from(_HDR_FMT, buf, 0)
    imu = struct.unpack_from(_IMU_FMT, buf, _HDR_SIZE)
    quat = np.array(imu[0:4])
    gyro = np.array(imu[4:7])
    accel = np.array(imu[7:10])
    rpy = np.array(imu[10:13])
    q = np.zeros(NUM_MOTORS)
    dq = np.zeros(NUM_MOTORS)
    tau = np.zeros(NUM_MOTORS)
    base = _HDR_SIZE + _IMU_SIZE
    for i in range(NUM_MOTORS):
        off = base + i * _MS_SIZE
        vals = struct.unpack_from(_MOTOR_STATE_FMT, buf, off)
        q[i], dq[i], tau[i] = vals[1], vals[2], vals[4]
    off = base + NUM_MOTORS * _MS_SIZE
    foot = np.array(struct.unpack_from("<4h", buf, off))
    (tick,) = struct.unpack_from("<I", buf, off + 16)
    return LowState(q=q, dq=dq, tau_est=tau, quat=quat, gyro=gyro,
                    accel=accel, rpy=rpy, foot_force=foot, tick=tick,
                    level_flag=lf)


# ---------------------------------------------------------------------------
# NatNet-style mocap rigid-body packet (the OptiTrack stream client role,
# hardware/hardware_robot.cpp:479-501 OptiTrackMonitor)
# ---------------------------------------------------------------------------

NATNET_FRAME_ID = 7                  # NAT_FRAMEOFDATA


@dataclasses.dataclass
class RigidBody:
    body_id: int
    pos: np.ndarray                  # [3] m
    quat: np.ndarray                 # [4] (x, y, z, w) — NatNet order


def encode_mocap_frame(frame: int, bodies: list[RigidBody]) -> bytes:
    """Minimal NatNet-style FrameOfMocapData: u16 message id, u16 payload
    size, i32 frame number, i32 body count, then per body i32 id + 3f pos
    + 4f quat (the rigid-body section layout of the NatNet stream the
    reference's OptiTrack client consumes)."""
    body = struct.pack("<ii", frame, len(bodies))
    for rb in bodies:
        body += struct.pack("<i3f4f", rb.body_id, *[float(v) for v in rb.pos],
                            *[float(v) for v in rb.quat])
    return struct.pack("<HH", NATNET_FRAME_ID, len(body)) + body


def decode_mocap_frame(buf: bytes):
    """-> (frame_number, [RigidBody]); None for non-frame messages."""
    if len(buf) < 4:
        return None
    mid, size = struct.unpack_from("<HH", buf, 0)
    if mid != NATNET_FRAME_ID or len(buf) < 4 + size:
        return None
    frame, count = struct.unpack_from("<ii", buf, 4)
    bodies = []
    off = 12
    for _ in range(count):
        bid, px, py, pz, qx, qy, qz, qw = struct.unpack_from("<i3f4f", buf,
                                                             off)
        off += 32
        bodies.append(RigidBody(body_id=bid, pos=np.array([px, py, pz]),
                                quat=np.array([qx, qy, qz, qw])))
    return frame, bodies
