"""Native host runtime: ctypes bindings over ``runtime.cpp`` (the port's own
copy of ``bilevel_gait_gen_tpu/runtime``).

See runtime.cpp for the components: a wait-free triple buffer, an
absolute-deadline rate loop, a single-pole low-pass filter bank and a
nonblocking UDP endpoint.  The shared library is built with
``g++ -O2 -shared -fPIC -std=c++17`` at first use into
``bilevel_gait_gen_tpu_torch/_build/runtime-<hash>/``, keyed by a hash of
the source (a changed source builds anew; an mtime does not count).  The
build writes to a temporary name and renames it into place, so processes
that build at the same time never load a half-written library.

Beyond the JAX package's bindings, :class:`UdpEndpoint` has a ``port``
property (the port the OS bound, for ``bind_port=0``) and ``set_peer``,
and :func:`loopback_pair` joins two endpoints on ports the OS chose.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "runtime.cpp"
BUILD_ROOT = _DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_SIGNATURES = {
    "bgg_tb_create": (_P, [ctypes.c_size_t]),
    "bgg_tb_destroy": (None, [_P]),
    "bgg_tb_write": (None, [_P, _P]),
    "bgg_tb_read": (ctypes.c_int, [_P, _P]),
    "bgg_rate_create": (_P, [ctypes.c_double]),
    "bgg_rate_destroy": (None, [_P]),
    "bgg_rate_wait": (ctypes.c_int64, [_P]),
    "bgg_rate_overruns": (ctypes.c_int64, [_P]),
    "bgg_rate_ticks": (ctypes.c_int64, [_P]),
    "bgg_lpf_create": (_P, [ctypes.c_size_t, ctypes.c_double,
                            ctypes.c_double]),
    "bgg_lpf_destroy": (None, [_P]),
    "bgg_lpf_step": (None, [_P, _P, _P]),
    "bgg_udp_create": (_P, [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                            ctypes.c_int]),
    "bgg_udp_destroy": (None, [_P]),
    "bgg_udp_send": (ctypes.c_long, [_P, _P, ctypes.c_size_t]),
    "bgg_udp_recv": (ctypes.c_long, [_P, _P, ctypes.c_size_t]),
    "bgg_udp_port": (ctypes.c_int, [_P]),
    "bgg_udp_set_peer": (None, [_P, ctypes.c_char_p, ctypes.c_int]),
}


def source_hash() -> str:
    """16 hex digits of the SHA-256 of the source and the compiler flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the shared library of this source lives once built."""
    return BUILD_ROOT / f"runtime-{source_hash()}" / "libbggrt.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def lib() -> ctypes.CDLL:
    """The runtime library, built at the first call if need be."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            L = ctypes.CDLL(str(path))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(L, name)
                fn.restype = res
                fn.argtypes = args
            _lib = L
    return _lib


class TripleBuffer:
    """Wait-free latest-value channel (MPC thread -> control thread)."""

    def __init__(self, n_doubles: int):
        self._n = n_doubles
        self._h = lib().bgg_tb_create(n_doubles)

    def write(self, arr: np.ndarray):
        a = np.ascontiguousarray(arr, dtype=np.float64).reshape(-1)
        if a.size != self._n:
            raise ValueError(f"{a.size} values for a buffer of {self._n}")
        lib().bgg_tb_write(self._h, a.ctypes.data_as(ctypes.c_void_p))

    def read(self) -> tuple[np.ndarray, bool]:
        out = np.empty(self._n, np.float64)
        fresh = lib().bgg_tb_read(self._h,
                                  out.ctypes.data_as(ctypes.c_void_p))
        return out, bool(fresh)

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.bgg_tb_destroy(self._h)


class RateLoop:
    """Absolute-deadline periodic loop (LoopFunc equivalent)."""

    def __init__(self, period_s: float):
        self._h = lib().bgg_rate_create(period_s)

    def wait(self) -> int:
        """Sleep to the next deadline; returns lateness (ns, >0 = overrun)."""
        return int(lib().bgg_rate_wait(self._h))

    @property
    def overruns(self) -> int:
        return int(lib().bgg_rate_overruns(self._h))

    @property
    def ticks(self) -> int:
        return int(lib().bgg_rate_ticks(self._h))

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.bgg_rate_destroy(self._h)


class LowPassBank:
    """Single-pole low-pass filter bank (HardwareRobot::LPF)."""

    def __init__(self, n: int, cutoff_hz: float, sample_hz: float):
        self._n = n
        self._h = lib().bgg_lpf_create(n, cutoff_hz, sample_hz)

    def step(self, x: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(x, dtype=np.float64).reshape(-1)
        if a.size != self._n:
            raise ValueError(f"{a.size} values for a bank of {self._n}")
        out = np.empty(self._n, np.float64)
        lib().bgg_lpf_step(self._h, a.ctypes.data_as(ctypes.c_void_p),
                           out.ctypes.data_as(ctypes.c_void_p))
        return out

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.bgg_lpf_destroy(self._h)


class UdpEndpoint:
    """Nonblocking UDP socket (robot I/O).  ``bind_port=0`` lets the OS
    choose the port; :attr:`port` reads it back."""

    def __init__(self, bind_ip: str, bind_port: int, peer_ip: str,
                 peer_port: int):
        self._h = lib().bgg_udp_create(bind_ip.encode(), bind_port,
                                       peer_ip.encode(), peer_port)
        if not self._h:
            raise OSError(f"failed to create a UDP endpoint on "
                          f"{bind_ip}:{bind_port}")

    @property
    def port(self) -> int:
        """The port this endpoint is bound to."""
        p = int(lib().bgg_udp_port(self._h))
        if p < 0:
            raise OSError("getsockname failed on the UDP endpoint")
        return p

    def set_peer(self, peer_ip: str, peer_port: int) -> None:
        """Send to ``peer_ip:peer_port`` from now on."""
        lib().bgg_udp_set_peer(self._h, peer_ip.encode(), peer_port)

    def send(self, data: bytes) -> int:
        buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
        return int(lib().bgg_udp_send(self._h, buf, len(data)))

    def recv(self, maxlen: int = 2048) -> bytes | None:
        buf = (ctypes.c_char * maxlen)()
        n = int(lib().bgg_udp_recv(self._h, buf, maxlen))
        if n < 0:
            return None
        return bytes(buf[:n])

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.bgg_udp_destroy(self._h)


def loopback_pair(ip: str = "127.0.0.1") -> tuple[UdpEndpoint, UdpEndpoint]:
    """Two endpoints on ``ip``, each bound to a port the OS chose and sending
    to the other."""
    a = UdpEndpoint(ip, 0, ip, 0)
    b = UdpEndpoint(ip, 0, ip, a.port)
    a.set_peer(ip, b.port)
    return a, b
