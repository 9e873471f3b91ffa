"""The port's native runtime (``bilevel_gait_gen_tpu_torch/runtime``: its own
``runtime.cpp``, built with g++ into ``_build/``) against the JAX package's
on the same inputs, and its build.

* the triple buffer and the low-pass bank of both runtimes fed the same
  seeded sequences give the same values bit for bit (the same C++);
* the port's triple buffer under a producer thread never tears a snapshot,
  its rate loop keeps its period, its low-pass bank starts at the first
  sample and has DC gain 1 (tests/test_runtime.py's checks);
* UDP: every endpoint binds port 0 and reads its port back (no fixed port,
  so none of the JAX tests' ports is touched); every receive polls with a
  deadline;
* the build: keyed by the source's hash, written to a temporary name and
  renamed, so that processes building at once all load a whole library.
"""
import ctypes
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bilevel_gait_gen_tpu import runtime as jrt
from bilevel_gait_gen_tpu_torch import runtime

RECV_DEADLINE_S = 2.0


def jax_runtime():
    """The JAX package's runtime, its library built first if missing, as
    that package would build it but to a temporary name renamed into place
    (its own ``lib()`` writes the library in place; several test processes
    may reach it at once)."""
    so = jrt._SO
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(jrt._SRC)):
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                            jrt._SRC, "-o", tmp], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return jrt


def recv_within(ep, deadline_s: float = RECV_DEADLINE_S):
    """The next datagram on ``ep``, polled until ``deadline_s`` seconds."""
    t_end = time.monotonic() + deadline_s
    while True:
        got = ep.recv(4096)
        if got is not None or time.monotonic() > t_end:
            return got
        time.sleep(1e-4)


def test_triple_buffers_of_both_runtimes_agree():
    rng = np.random.default_rng(0)
    ours, theirs = runtime.TripleBuffer(5), jax_runtime().TripleBuffer(5)
    for k in range(40):
        if rng.random() < 0.6:
            x = rng.standard_normal(5)
            ours.write(x)
            theirs.write(x)
        (a, fa), (b, fb) = ours.read(), theirs.read()
        np.testing.assert_array_equal(a, b)
        assert fa == fb, k


def test_triple_buffer_latest_value():
    tb = runtime.TripleBuffer(4)
    out, fresh = tb.read()
    assert not fresh
    tb.write(np.array([1.0, 2, 3, 4]))
    out, fresh = tb.read()
    assert fresh
    np.testing.assert_array_equal(out, [1, 2, 3, 4])
    out, fresh = tb.read()
    assert not fresh
    tb.write(np.array([5.0, 6, 7, 8]))
    tb.write(np.array([9.0, 10, 11, 12]))
    out, fresh = tb.read()
    assert fresh
    np.testing.assert_array_equal(out, [9, 10, 11, 12])
    with pytest.raises(ValueError):
        tb.write(np.zeros(3))


def test_triple_buffer_never_tears_under_a_producer_thread():
    """Producers at full speed, the interpreter switching threads every
    microsecond: every snapshot read is a whole (x, x + 0.5) pair."""
    tb = runtime.TripleBuffer(2)
    tb.write(np.array([0.0, 0.5]))
    stop = threading.Event()
    errors = []
    switch = sys.getswitchinterval()

    def producer():
        i = 0
        while not stop.is_set():
            tb.write(np.array([float(i), float(i) + 0.5]))
            i += 1

    sys.setswitchinterval(1e-6)
    th = threading.Thread(target=producer)
    th.start()
    try:
        t_end = time.monotonic() + 0.3
        reads = 0
        while time.monotonic() < t_end:
            out, _ = tb.read()
            reads += 1
            if out[1] != out[0] + 0.5:
                errors.append(out.copy())
    finally:
        stop.set()
        th.join(timeout=10.0)
        sys.setswitchinterval(switch)
    assert not th.is_alive()
    assert reads > 100 and not errors, errors[:5]


def test_low_pass_banks_of_both_runtimes_agree():
    rng = np.random.default_rng(1)
    ours = runtime.LowPassBank(6, cutoff_hz=20.0, sample_hz=240.0)
    theirs = jax_runtime().LowPassBank(6, cutoff_hz=20.0, sample_hz=240.0)
    for _ in range(200):
        x = rng.standard_normal(6) * 3.0
        np.testing.assert_array_equal(ours.step(x), theirs.step(x))


def test_low_pass_bank_starts_at_the_first_sample_with_dc_gain_one():
    f = runtime.LowPassBank(3, cutoff_hz=10.0, sample_hz=1000.0)
    x = np.array([1.0, -2.0, 3.0])
    np.testing.assert_array_equal(f.step(x), x)
    f2 = runtime.LowPassBank(1, cutoff_hz=10.0, sample_hz=1000.0)
    f2.step(np.zeros(1))
    for _ in range(2000):
        y = f2.step(np.ones(1))
    np.testing.assert_allclose(y, 1.0, atol=1e-6)
    with pytest.raises(ValueError):
        f2.step(np.ones(2))


def test_rate_loop_timing():
    rl = runtime.RateLoop(0.002)
    t0 = time.perf_counter()
    for _ in range(50):
        rl.wait()
    elapsed = time.perf_counter() - t0
    assert 0.07 < elapsed < 0.2, elapsed
    assert rl.ticks == 50
    assert 0 <= rl.overruns <= 50


def test_udp_loopback_on_ports_the_os_chose():
    a, b = runtime.loopback_pair()
    assert a.port > 0 and b.port > 0 and a.port != b.port
    msg = b"\x01\x02state-packet\x03"
    assert a.send(msg) == len(msg)
    assert recv_within(b) == msg
    assert b.recv() is None                   # nonblocking when empty
    assert b.send(b"reply") == 5
    assert recv_within(a) == b"reply"


def test_udp_endpoint_binds_port_zero_and_set_peer_redirects():
    a = runtime.UdpEndpoint("127.0.0.1", 0, "127.0.0.1", 0)
    b = runtime.UdpEndpoint("127.0.0.1", 0, "127.0.0.1", a.port)
    c = runtime.UdpEndpoint("127.0.0.1", 0, "127.0.0.1", a.port)
    a.set_peer("127.0.0.1", b.port)
    a.send(b"to-b")
    assert recv_within(b) == b"to-b"
    a.set_peer("127.0.0.1", c.port)
    a.send(b"to-c")
    assert recv_within(c) == b"to-c"
    assert b.recv() is None


def test_the_build_is_keyed_by_the_source_hash(tmp_path, monkeypatch):
    """A changed source has another library path; the build leaves no
    temporary file behind; threads building at once each leave a whole
    library with every entry point."""
    path = runtime.library_path()
    assert path.parent.parent == runtime.BUILD_ROOT
    assert path.parent.name == f"runtime-{runtime.source_hash()}"
    src = tmp_path / "runtime.cpp"
    src.write_text(runtime.SRC.read_text() + "\n// changed\n")
    monkeypatch.setattr(runtime, "SRC", src)
    monkeypatch.setattr(runtime, "BUILD_ROOT", tmp_path / "_build")
    moved = runtime.library_path()
    assert moved.parent.name != path.parent.name
    threads = [threading.Thread(target=runtime._build, args=(moved,))
               for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120.0)
    assert not any(th.is_alive() for th in threads)
    assert [p.name for p in moved.parent.iterdir()] == ["libbggrt.so"]
    lib = ctypes.CDLL(str(moved))
    for name in runtime._SIGNATURES:
        assert hasattr(lib, name), name
