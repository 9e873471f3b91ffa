#!/usr/bin/env python3
"""Batched matrix-vector products on the card: which forms give one
scenario the same bits at every batch, and what each costs.

    python3 scripts/torch_batched_matvec.py            # on the card
    python3 scripts/torch_batched_matvec.py --cpu      # a small check here

For each shape the port multiplies (the closed loop's and the bench RTI's:
M [B, r, c] times a vector per scenario, and the transposed product), each
form is run at batches 1, 8, 64 and 128 on the same leading scenarios
(float32, inputs from a seeded generator) and its outputs held to batch
128's bit for bit; at batch 128 each is timed with CUDA events (median of
20 windows of 10 calls in a row).  Forms: ``bmm`` (``M @ v[..., None]``,
what the port wrote), ``mulsum`` (``(M * v[..., None, :]).sum(-1)``; for
v^T M the sum over axis -2), ``copy_mulsum`` (v^T M as the sum over the last
axis of a contiguous copy of M^T), ``pad8`` (``bmm`` on v padded to 8
columns).  Prints one line a shape and form, then one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

BATCHES = (1, 8, 64, 128)
# (label, r, c, leading factor): the product M [B f, r, c] x v [B f, c]
SHAPES = (
    ("rti small cfg H x", 120, 120, 1),
    ("rti small cfg G x", 288, 120, 1),
    ("wbqp G x", 44, 30, 1),
    ("ik J^T y", 12, 12, 1),
    ("physics J^T f", 18, 12, 1),
    ("rbd link inertia", 3, 3, 13),
    ("bench RTI G x", 1232, 232, 1),
    ("bench RTI H x", 232, 232, 1),
    ("bench RTI A x", 16, 232, 1),
)
TSHAPES = (                      # v^T M: [B, r] x [B, r, c] -> [B, c]
    ("rti small cfg v^T A", 56, 20, 1),
    ("rti small cfg G^T lam", 288, 120, 1),
    ("bench RTI A^T y", 16, 232, 1),
    ("bench RTI G^T lam", 1232, 232, 1),
)


def forms(transposed: bool):
    if transposed:
        return {
            "bmm": lambda M, v: (v[..., None, :] @ M)[..., 0, :],
            "mulsum": lambda M, v: (v[..., :, None] * M).sum(-2),
            "copy_mulsum": lambda M, v: (M.mT.contiguous()
                                         * v[..., None, :]).sum(-1),
            "pad8": lambda M, v: (torch.cat([v[..., None, :], v.new_zeros(
                *v.shape[:-1], 7, v.shape[-1])], -2) @ M)[..., 0, :],
        }
    return {
        "bmm": lambda M, v: (M @ v[..., None])[..., 0],
        "mulsum": lambda M, v: (M * v[..., None, :]).sum(-1),
        "pad8": lambda M, v: (M @ torch.cat([v[..., None], v.new_zeros(
            *v.shape, 7)], -1))[..., 0],
    }


def cuda_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` of the time of ``inner`` calls in a row between
    two CUDA events, divided by ``inner``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return sorted(times)[len(times) // 2]


def run(device: str, batches=BATCHES) -> list[dict]:
    gen = torch.Generator(device="cpu").manual_seed(0)
    top = max(batches)
    rows = []
    for transposed, shapes in ((False, SHAPES), (True, TSHAPES)):
        for label, r, c, f in shapes:
            M = torch.randn(top * f, r, c, generator=gen).to(device)
            v = torch.randn(top * f, r if transposed else c,
                            generator=gen).to(device)
            for name, fn in forms(transposed).items():
                ref = fn(M, v)
                apart = {}
                for b in batches[:-1]:
                    got = fn(M[:b * f].contiguous(), v[:b * f].contiguous())
                    apart[b] = float((got.double() - ref[:b * f].double())
                                     .abs().max())
                ms = (cuda_ms(lambda: fn(M, v)) if device == "cuda"
                      else None)
                rows.append(dict(shape=label, M=[top * f, r, c],
                                 transposed=transposed, form=name,
                                 apart=apart, ms=ms))
                print(f"{label:22s} {name:8s} M {[top * f, r, c]}: apart from "
                      f"batch {top} at "
                      + ", ".join(f"{b}: {d:.2e}" for b, d in apart.items())
                      + (f"; {ms:.4f} ms at {top}" if ms is not None else ""),
                      flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    if not a.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (use --cpu)")
    device = "cpu" if a.cpu else "cuda"
    if device == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    rows = run(device, (1, 2, 4) if a.cpu else BATCHES)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
