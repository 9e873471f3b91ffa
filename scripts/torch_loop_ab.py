#!/usr/bin/env python3
"""The flagship closed loop's graphed RTI period and control tick on the
card, for the port in a given checkout (an A/B of two trees in one call).

    python3 scripts/torch_loop_ab.py [--root DIR] [--reps 3] [--label L]

From the checkout at DIR (default: this one) it imports the package and
``chip_smoke.py``, builds phase 8's flagship start (``loop_start``: batch
128, float32), captures one RTI period (MPC_EVERY ticks, the RTI on the
first) as a CUDA graph and replays it ``--reps`` times: the real-time
factor of a period is B x simulated s / wall s of a replay.  Then one
control tick graphed: its median ms of 10 replays, and its device
operations and busy share under ``torch.profiler``.  Prints the card's name
and power limit, then one JSON line.  Run it from the root of either tree,
alternating the trees within one call (parent, change, change, parent):
numbers of two calls are not compared.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.sim import engine
    from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed, tree_map
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    cfg, wb, sim = c.loop_configs()
    B = c.LOOP_BATCH
    model, params, st, q0, v0, x_des = c.loop_start(cfg, sim, B, "cuda",
                                                    torch.float32)
    ls0 = engine.initial_state(model, cfg, sim, st, q0, v0)

    def period(ls):
        return engine.period(model, params, cfg, wb, sim, x_des, ls,
                             control_dt=c.CONTROL_DT, ticks=c.MPC_EVERY,
                             gait=False, contact_sync=True)

    g = Graphed(period, ls0, carry={0: lambda out: out[0]})
    period_s = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g(ls0)
        torch.cuda.synchronize()
        period_s.append(time.perf_counter() - t0)
    ls1 = tree_map(torch.clone, g.args[0])
    g.close()
    t = (ls1.tick.to(torch.float32) * c.CONTROL_DT).expand(B)

    def tick(q, v, mc):
        return engine.control_tick(model, params, cfg, wb, sim, ls1.st, q, v,
                                   t, t, mc, control_dt=c.CONTROL_DT)

    gt = Graphed(tick, ls1.q, ls1.v, ls1.mc)
    tick_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gt()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    prof = kc.profile_call(gt, "graphed control tick")
    gt.close()
    sim_s = c.MPC_EVERY * c.CONTROL_DT
    print(json.dumps({
        "label": args.label, "root": args.root, "card": card, "batch": B,
        "period_ticks": c.MPC_EVERY,
        "period_ms": [s * 1e3 for s in period_s],
        "period_rtf": [B * sim_s / s for s in period_s],
        "tick_ms_median": float(np.median(tick_ms)), "tick_ms": tick_ms,
        "tick_device_ops": prof["device_ops"],
        "tick_busy_share": prof["busy_share_of_wall"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
