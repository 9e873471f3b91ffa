#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card:

    python3 benchmark/control.py --workload a1_walk_n20.fleet_b128 \\
        --seeds 11,12,13 --seconds 5 --out chiprun_out/control.json

For each seed, a run of the cell (its set-up, a window of ``--seconds``,
its comparison) with every number the comparison makes, read three ways
against the float64 reference from the same inputs: the program's answers
(``program``, whose largest reading over a dozen seeds or more is the
lower reading of a limit), the control (``control_tf32``: the reference
put in the program's place in float32 with TF32 products, the precision
below the configuration's float32 with TF32 off, whose smallest reading is
the upper one) and the reference in plain float32 (``plain_float32``,
for comparison), and the program against the plain float32 reference
(``program_vs_float32``, a second witness).  With ``--fault <name>`` the
program runs with that fault of ``faults.py`` planted underneath, and its
readings show whether the limits see it at the cell's own size.  Prints
one JSON line per seed and writes them all to ``--out``.  The benchmark's
own runs do not run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import faults  # noqa: E402
from benchmark.harness import core  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """One seed's run of the cell with the control read beside it."""
    t0 = time.perf_counter()
    ctx = core.load_ctx(workload, seed, seconds, False, t0, device)
    ctx.control = True
    if overrides:
        ctx.traffic = {**ctx.traffic, **overrides}
    out = core.kind_module(ctx).run(ctx)
    return {"seed": seed, "correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "e2e": out.e2e, "readings": out.readings,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    a = ap.parse_args(argv)
    core.set_caches()
    core.require_card(1)
    if a.fault:
        faults.FAULTS[a.fault](setattr)
    lines = []
    for s in a.seeds.split(","):
        line = readings(a.workload, int(s), a.seconds)
        line["fault"] = a.fault
        print(json.dumps(line), flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(json.dumps(x) for x in lines)
                               + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
