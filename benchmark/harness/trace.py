"""The traced run's arithmetic: the device's busy time from a
``torch.profiler`` trace (the union of its kernels' and copies'
intervals, as ``ops/kernel_checks.profile_call`` of the port takes it),
the operations that took most time, the longest idle gaps by what the host
was doing, and the CUDA-event timings of a call replayed alone."""
from __future__ import annotations

import time

import numpy as np

TOP = 10
NAME = 160   # characters of an operation's name kept in the breakdown


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median over ``reps`` timings of one call between two CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graphed_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph (after two on a side stream), the graph replayed between two
    CUDA events (median of ``reps``), over ``calls``; no host time is in
    the window."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    ms = cuda_ms(g.replay, reps=reps) / calls
    g.reset()
    return ms


def busy_union(spans) -> float:
    """The length covered by a set of (start, end) intervals."""
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def profile(call) -> dict:
    """``call()`` once under ``torch.profiler`` (after it has run untraced):
    ``busy_s`` (the union of the device operations' intervals),
    ``window_s`` (from the first device operation's start to the last
    one's end; the host's wall time of the traced call, which carries the
    profiler's own start, is ``wall_s``), ``device_ops`` (their count), and a
    ``breakdown``: the device operations by total time, and the idle gaps
    between them by the host operation under way when each gap began, each
    a list of at most 10 [name, seconds]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy = busy_union(spans) / 1e6
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = idle_gaps(spans, [(e.time_range.start, e.time_range.end, e.name)
                             for e in host])
    window = (max(b for _, b in spans) - spans[0][0]) / 1e6 if spans else 0.0
    return {"busy_s": busy, "window_s": window, "wall_s": wall,
            "device_ops": len(dev),
            "breakdown": {"device_ops": [[n[:NAME], s] for n, s in ops],
                          "idle_gaps": gaps}}


def idle_gaps(spans, host) -> list:
    """The device's idle gaps between its operations (microsecond spans),
    summed by the innermost host operation under way where each began
    ("host: none" where none was), the 10 largest sums, in seconds."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = sorted(host)
    by_host: dict[str, float] = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        gap = nxt - end
        if gap <= 0:
            continue
        name = "host: none"
        inner = None
        for a, b, n in starts:
            if a > end:
                break
            if b >= end and (inner is None or b - a < inner):
                inner, name = b - a, n
        by_host[name] = by_host.get(name, 0.0) + gap / 1e6
    return [[n[:NAME], s] for n, s in sorted(by_host.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def span_ms(call, reps: int, device: str) -> list[float]:
    """Milliseconds of ``reps`` synchronized calls after one untimed call:
    between two CUDA events on the card (a graph replay is one launch, so
    the host's share is that launch), on the host's clock elsewhere."""
    call()
    if device != "cuda":
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    import torch
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out
