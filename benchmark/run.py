#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload a1_walk_n20.fleet_b128 \\
        --seed 7 --seconds 30 --trace 0

Prints progress and the numbers compared (each beside its limit) on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``.  It
exits non-zero, and prints no result, without a CUDA device (or with fewer
than the cell asks for), where the port is missing, and where the process
has loaded JAX or the JAX package.  See ``benchmark/README.md``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import core  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: str = "cuda", overrides: dict | None = None,
         t_start: float | None = None) -> dict:
    """One run; returns the result line (also printed).  ``device`` and
    ``overrides`` (keys of the traffic file replaced) are for the
    benchmark's own tests on the CPU, which skip the look for a card."""
    a = parse(argv)
    core.set_caches()
    ctx = core.load_ctx(a.workload, a.seed, a.seconds, bool(a.trace),
                        T_START if t_start is None else t_start, device)
    if overrides:
        ctx.traffic = {**ctx.traffic, **overrides}
    if device == "cuda":
        card = core.require_card(ctx.chips)
        count = ctx.chips
    else:
        card, count = device, 1
    out = core.kind_module(ctx).run(ctx)
    found = core.forbidden_modules()
    if found:
        raise RuntimeError(f"the run's process loaded {found}")
    line = core.result_line(ctx, out, card, count)
    print(json.dumps({"readings": out.readings}), file=sys.stderr)
    for name, c in line["checks"].items():
        if isinstance(c, dict):
            print(f"[check] {name}: {c['value']!r} (limit {c['limit']!r})",
                  file=sys.stderr)
        else:
            print(f"[check] {name}: {c}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    try:
        main()
    except core.NoCard as exc:
        print(f"no card: {exc}", file=sys.stderr)
        sys.exit(3)
