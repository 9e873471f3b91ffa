#!/usr/bin/env python3
"""Closed-loop gait-optimization A/B against MuJoCo physics on the PyTorch
port (port of scripts/gait_opt_experiment.py; reference analog
test/gait_opt_line_search.cpp:112-203).  The scenario is a deliberately
mistimed trot (every phase stretched ``--stretch`` x), and both arms run
the same MuJoCo physics through ``sim/closed_loop.run_closed_loop``:

  gait-off: plain RTIs on the stretched schedule;
  gait-on:  every ``gait_opt_freq``-th RTI replaced by the full bilevel
            update (MPCController::MPCUpdate's 3-phase cycle).

The decider is the converged late-rollout planning cost (the last fifth of
the MPC ticks); the JAX script's comments give why.  The configuration has
the Raibert rows on, so the gait update's QP has p > 32 equality rows.

Exit 0 iff the gait-on arm stays upright and its late cost beats the
gait-off arm's in a majority of the scenarios.  Needs ``mujoco``; without
``--cpu`` the controller runs on the GPU, which must be there.

Usage: python scripts/torch_gait_opt_experiment.py [seconds] [--cpu]
       [--stretch=S] [--freq=K]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bilevel_gait_gen_tpu_torch import resolve_device  # noqa: E402
from bilevel_gait_gen_tpu_torch.control import wbqp  # noqa: E402
from bilevel_gait_gen_tpu_torch.models import a1  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc import gait  # noqa: E402
from bilevel_gait_gen_tpu_torch.sim.closed_loop import (  # noqa: E402
    run_closed_loop, settled_start)
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig  # noqa: E402


def configure(argv):
    """(seconds, stretches, freq, cfg) from the command line
    (gait_opt_experiment.py:46-62)."""
    args = [a for a in argv if not a.startswith("--")]
    seconds = float(args[0]) if args else 3.0
    stretches = [1.25, 1.4, 1.6]
    freq = 10
    for a in argv:
        if a.startswith("--stretch="):
            # one mistiming in place of the 3-stretch majority
            stretches = [float(a.split("=", 1)[1])]
        elif a.startswith("--freq="):
            freq = int(a.split("=", 1)[1])
    cfg = MPCConfig(ipm_iters=18, double_support=0.1, force_carrier=True,
                    carrier_ramp=0.1, raibert=True,
                    raibert_vel_gain=(1.8, 1.2)).validate()
    return seconds, stretches, freq, cfg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else resolve_device(None)
    seconds, stretches, freq, cfg = configure(argv)
    dtype = torch.float32
    model = a1.make_a1(device=device)
    q0 = settled_start(model, np.asarray(a1.stand_config(), np.float64))
    v0 = np.zeros(model.nv)
    wins = 0
    for stretch in stretches:
        sched = gait.GaitSchedule(bounds=gait.make_trot(
            cfg, dtype=dtype, device=device).bounds * stretch)
        results = {}
        for arm, gof in (("gait-off", 0), ("gait-on", freq)):
            t0 = time.time()
            res = run_closed_loop(model, cfg, wbqp.WBQPConfig(), q0, v0,
                                  seconds, sched=sched, gait_opt_freq=gof,
                                  device=device, dtype=dtype)
            # decider: the converged late-rollout planning cost
            avg = float(np.mean(res.costs[5:]))
            k = max(len(res.costs) // 5, 1)
            late = float(np.mean(res.costs[-k:]))
            upright = bool(res.z.min() > 0.15)
            results[arm] = (late, upright, res)
            print(f"[x{stretch}] {arm}: wall {time.time()-t0:.0f}s  "
                  f"solves {res.n_mpc} (fails {res.n_fails}"
                  + (f", accepts {res.n_gait_accepts}" if gof else "")
                  + f")  z_min {res.z.min():.3f}  avg-cost {avg:+.0f}  "
                  f"late-cost {late:+.0f}  "
                  + ("UPRIGHT" if upright else "FELL"), flush=True)

        off_cost, off_up, _ = results["gait-off"]
        on_cost, on_up, res_on = results["gait-on"]
        b = np.asarray(res_on.final_bounds)
        stance = (b[:, 1:] - b[:, :-1])[:, ::2]
        print(f"[x{stretch}] optimized stance lengths (nominal "
              f"{0.4 * stretch:.2f} stretched, {0.4:.2f} true): "
              f"{np.round(stance[:, 1:3].mean(axis=1), 3)}")
        win = on_up and (on_cost < off_cost)
        wins += int(win)
        print(f"[x{stretch}] " + ("WIN" if win else "LOSS"), flush=True)

    need = len(stretches) // 2 + 1
    print(f"GAIT-OPT {'WINS' if wins >= need else 'LOSES'} "
          f"({wins}/{len(stretches)} scenarios)")
    return 0 if wins >= need else 1


if __name__ == "__main__":
    raise SystemExit(main())
