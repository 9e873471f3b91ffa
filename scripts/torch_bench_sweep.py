#!/usr/bin/env python3
"""Batch-size / kernel sweep of the inner-RTI throughput on the PyTorch
port (port of scripts/bench_sweep.py; a tuning aid).

For each QP kernel of SWEEP_KERNELS ("xla": the unrolled sweeps; "pallas":
every sweep through the hand-written ``ipm_iter``) and each batch of
SWEEP_BATCHES it times the steady warm-started batched ``solve_step``
(``parallel/mesh.batched_solve_step``: one CUDA graph on the card, captured
at the first call; eager on the CPU) and prints a line per point.  The
perturbations are drawn with a numpy generator seeded 0 where the JAX
script uses ``PRNGKey(0)``.

Usage: SWEEP_KERNELS=xla,pallas SWEEP_BATCHES=128,1024 \\
       python scripts/torch_bench_sweep.py [--cpu]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bilevel_gait_gen_tpu_torch import resolve_device  # noqa: E402
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc import gait, solver  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (  # noqa: E402
    default_trajectory)
from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map  # noqa: E402

SWEEP_KERNELS = os.environ.get("SWEEP_KERNELS", "xla").split(",")
SWEEP_BATCHES = [int(b) for b in os.environ.get(
    "SWEEP_BATCHES", "128,256,512,1024").split(",")]


def setup(batch: int, kernel: str, device, dtype=torch.float32) -> dict:
    """bench_sweep.py:29-46: the configuration, the step and its
    arguments (states, x0s, t0, feets, x_des [12])."""
    cfg = MPCConfig(ipm_iters=10, ipm_exact_every=3,
                    qp_kernel=kernel).validate()
    device = resolve_device(device)
    model = a1.make_a1(device=device)
    q0 = torch.tensor(a1.stand_config(), device=device).to(dtype)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0, torch.zeros(model.nv, dtype=dtype,
                                                       device=device))
    feet0 = rbd.ee_positions(model, q0).to(dtype)
    traj = default_trajectory(cfg, gait.make_trot(cfg, dtype=dtype,
                                                  device=device),
                              x0[None], feet0[None, :, :2])
    state = solver.make_state(cfg, traj, torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    pert = 0.02 * np.random.default_rng(0).standard_normal((batch, 13))
    pert[:, 6:10] = 0.0
    x0s = x0 + torch.tensor(pert, device=device).to(dtype)
    args = (tree_map(lambda a: a.repeat_interleave(batch, 0), state), x0s,
            0.0, feet0.expand(batch, -1, -1).contiguous(),
            srb.manifold_to_tangent(x0))
    return dict(cfg=cfg, step=mesh_mod.batched_solve_step(cfg, params),
                args=args)


def run(batch: int, kernel: str, device, n_rep: int = 8) -> dict:
    """One point: a first (capturing) call, then ``n_rep`` timed steps
    fed back on their states.  Prints the JAX script's line; returns its
    numbers."""
    case = setup(batch, kernel, device)
    step, (states, x0s, t0, feets, x_des) = case["step"], case["args"]
    sync = torch.cuda.synchronize if x0s.is_cuda else (lambda: None)
    try:
        states, stats = step(states, x0s, t0, feets, x_des)
        sync()
        t_start = time.perf_counter()
        for _ in range(n_rep):
            states, stats = step(states, x0s, t0, feets, x_des)
        sync()
        el = time.perf_counter() - t_start
    finally:
        step.close()
    lat = el / n_rep * 1e3
    solved = float(stats.solved.float().mean())
    print(f"kernel={kernel:7s} batch={batch:5d} latency={lat:8.2f} ms  "
          f"throughput={batch * n_rep / el:9.1f} solves/s  "
          f"solved={solved:.3f}", flush=True)
    return dict(kernel=kernel, batch=batch, latency_ms=lat,
                solves_per_s=batch * n_rep / el, solved=solved)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else resolve_device(None)
    for k in SWEEP_KERNELS:
        for b in SWEEP_BATCHES:
            run(b, k, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
