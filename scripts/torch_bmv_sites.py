#!/usr/bin/env python3
"""Launches of ``kernels.bmv`` by call shape on the card: in one control
tick of the flagship closed loop and in one bench cadence cycle, batch 128,
float32.

    python3 scripts/torch_bmv_sites.py [--root DIR]

From the checkout at DIR (default: this one) it builds phase 8's loop start
(``chip_smoke.loop_start``) and runs one period (the RTI and its ticks) and
then one more control tick, eagerly, then phase 4's bench problem
(``problem.make_problem``) and one cadence cycle (``mpc/cadence.cycle``),
with every ``kernels.bmv`` launch recorded by X's and Y's shapes.  An eager
call launches what its graph replays.  Prints the card's name and power
limit, then one JSON line: {"tick": [[X shape, Y shape, launches], ...],
"cycle": [...]}, largest counts first."""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from bilevel_gait_gen_tpu_torch.ops import kernels
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    from bilevel_gait_gen_tpu_torch.sim import engine
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    seen = collections.Counter()
    forward = kernels._bmv_forward

    def recorded(X, Y):
        before = kernels.bmv.launches
        out = forward(X, Y)
        if kernels.bmv.launches > before:
            seen[(tuple(X.shape), tuple(Y.shape))] += 1
        return out

    kernels._bmv_forward = recorded
    cfg, wb, sim = c.loop_configs()
    model, params, st, q0, v0, x_des = c.loop_start(cfg, sim, c.LOOP_BATCH,
                                                    "cuda", torch.float32)
    ls = engine.initial_state(model, cfg, sim, st, q0, v0)
    ls = engine.period(model, params, cfg, wb, sim, x_des, ls,
                       control_dt=c.CONTROL_DT, ticks=c.MPC_EVERY, gait=False,
                       contact_sync=True)[0]
    t = (ls.tick.to(torch.float32) * c.CONTROL_DT).expand(c.LOOP_BATCH)
    seen.clear()
    engine.control_tick(model, params, cfg, wb, sim, ls.st, ls.q, ls.v, t, t,
                        ls.mc, control_dt=c.CONTROL_DT)
    torch.cuda.synchronize()
    out = {"tick": seen.most_common()}
    bcfg = c.bench_config()
    pr = make_problem(bcfg, c.BATCH, device="cuda", dtype=torch.float32)
    seen.clear()
    c.run_cadence(bcfg, pr, 1)
    out["cycle"] = seen.most_common()
    print(json.dumps({k: [[list(x), list(y), n] for (x, y), n in v]
                      for k, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
