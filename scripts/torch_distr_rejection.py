#!/usr/bin/env python3
"""Disturbance rejection on the PyTorch port (port of
scripts/distr_rejection.py, whose docstring gives the reference scenario:
apps/a1_config_distr_rejection.yaml).

Two modes:
  default        the plan-level scenario batch: the initial SQP of the
                 push-recovery configuration (N=50 at dt=0.02, 18 sweeps)
                 for a batch of pushes up to 2.5 m/s in random directions,
                 the batch sharded over the scenario mesh when it has more
                 than one rank (``parallel/mesh.batched_initial_run``; one
                 CUDA graph on the card, captured at the first call);
  --closed-loop  the reference's scenario end to end through
                 ``sim/closed_loop.run_push_recovery`` (MuJoCo physics and
                 the controller), exits 0 iff the robot recovers.

The pushes are drawn with a numpy generator seeded 0 where the JAX script
uses ``PRNGKey(0)``: the same distributions, other draws.  Without
``--cpu`` it runs on the GPU and raises when there is none.

Usage: python scripts/torch_distr_rejection.py [batch] [--cpu]
       [--closed-loop] [--vx=0.375] [--sweep[=lo:hi:step]]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from bilevel_gait_gen_tpu_torch import resolve_device  # noqa: E402
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc import gait, solver  # noqa: E402
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (  # noqa: E402
    default_trajectory)
from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from bilevel_gait_gen_tpu_torch.parallel import multihost  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map  # noqa: E402


def closed_loop_main(argv, device) -> int:
    """distr_rejection.py:44-79: one push speed (``--vx``) or a sweep."""
    from bilevel_gait_gen_tpu_torch.sim.closed_loop import run_push_recovery
    vx, sweep = 0.375, None
    for a in argv:
        if a.startswith("--vx="):
            vx = float(a.split("=", 1)[1])
        elif a.startswith("--sweep"):
            parts = a.split("=", 1)[1].split(":") if "=" in a else []
            lo, hi, st = ([float(p) for p in parts] if len(parts) == 3
                          else (0.30, 0.60, 0.05))
            sweep = np.arange(lo, hi + st / 2, st)
    speeds = sweep if sweep is not None else [vx]
    all_ok = True
    for v in speeds:
        print(f"closed-loop push recovery: init_vx={v:.3f} m/s "
              f"(reference init_vel, a1_config_distr_rejection.yaml:37)")
        t0 = time.time()
        res = run_push_recovery(init_vx=float(v), seconds=2.5, device=device)
        ok = res.recovered()
        all_ok &= ok
        v_end = float(np.abs(res.vs[-500:, 0]).mean())
        print(f"wall {time.time()-t0:.0f}s  MPC solves {res.n_mpc} "
              f"(fails {res.n_fails})  flight {res.flight_s:.3f}s")
        print(f"z: min {res.z.min():.3f} end {res.z[-1]:.3f}  "
              f"x_end {res.qs[-1,0]:+.3f}  |vx|_end {v_end:.2f}")
        print("RECOVERED" if ok else "FELL", flush=True)
    if sweep is not None:
        print(("SWEEP RECOVERED" if all_ok else "SWEEP FELL")
              + f" ({len(speeds)} speeds {speeds[0]:.2f}..{speeds[-1]:.2f})")
    return 0 if all_ok else 1


def config() -> MPCConfig:
    """The reference push-recovery configuration
    (a1_config_distr_rejection.yaml): N=50 at dt=0.02, force bound 200,
    mu 0.6, z-heavy weights."""
    return MPCConfig(num_nodes=50, dt=0.02, ipm_iters=18,
                     force_bound=200.0, friction_coef=0.6, force_cost=0.001,
                     q_diag=(140.0, 140.0, 12000.0, 0.015, 0.015, 10.0,
                             3000.0, 3000.0, 3000.0, 1.0, 1.0,
                             1.0)).validate()


def setup(batch: int, device, dtype=torch.float32, seed: int = 0) -> dict:
    """distr_rejection.py:84-112: the configuration, the SRB parameters,
    ``batch`` copies of the stand's solver state, the measured states with
    linear momenta of pushes |v| ~ U(0, 2.5) m/s in directions ~ U(0, 2 pi)
    (``speeds`` [batch], numpy), the feet and the target x_des [12]."""
    cfg = config()
    device = resolve_device(device)
    model = a1.make_a1(device=device)
    q0 = torch.tensor(a1.stand_config(), device=device).to(dtype)
    params = srb.make_srb_params(model, q0)
    feet0 = rbd.ee_positions(model, q0).to(dtype)
    x_nom = srb.reconstruct_state(params, q0, torch.zeros(
        model.nv, dtype=dtype, device=device))
    rng = np.random.default_rng(seed)
    speeds = rng.uniform(0.0, 2.5, batch)
    angles = rng.uniform(0.0, 2 * np.pi, batch)
    x0s = x_nom.repeat(batch, 1)
    v = torch.tensor(np.stack([speeds * np.cos(angles),
                               speeds * np.sin(angles)], 1),
                     device=device).to(dtype)
    x0s[:, 3:5] = params.mass * v
    traj = default_trajectory(cfg, gait.make_trot(cfg, dtype=dtype,
                                                  device=device),
                              x_nom[None], feet0[None, :, :2])
    state1 = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    return dict(cfg=cfg, params=params, speeds=speeds, x0s=x0s,
                states=tree_map(lambda a: a.repeat_interleave(batch, 0),
                                state1),
                feets=feet0.expand(batch, -1, -1).contiguous(),
                x_des=srb.manifold_to_tangent(x_nom))


def plan(case: dict, device) -> dict:
    """The batched initial run, twice (the first call with its capture on
    the card); in a process group of more than one rank the batch is
    sharded over the scenario mesh and the results gathered after.  Adds
    states2, stats, t_first, t_steady [s]."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    args = (case["states"], case["x0s"], case["feets"])
    if world > 1:
        mesh = mesh_mod.make_mesh(device=device)
        args = tuple(mesh_mod.shard_batch(a, mesh) for a in args)
    print(f"device: {torch.device(device)}, ranks: {world}  "
          f"batch: {case['x0s'].shape[0]}")
    run = mesh_mod.batched_initial_run(case["cfg"], case["params"])
    sync = torch.cuda.synchronize if case["x0s"].is_cuda else (lambda: None)
    try:
        t0 = time.perf_counter()
        run(*args, case["x_des"])
        sync()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        states2, stats = run(*args, case["x_des"])
        sync()
        t_steady = time.perf_counter() - t0
    finally:
        run.close()
    if world > 1:
        group = mesh["scenario"].get_group()
        states2, stats = tree_map(lambda d: multihost.all_gather(
            d.to_local(), group), (states2, stats))
    return dict(case, states2=states2, stats=stats, t_first=t_first,
                t_steady=t_steady)


def report(run: dict) -> dict:
    """distr_rejection.py:131-153's lines; returns their numbers."""
    cfg, B = run["cfg"], run["x0s"].shape[0]
    solved = run["stats"].solved.cpu().numpy()
    x_man = run["states2"].traj.x_man.cpu().numpy()
    # the plan's own metrics: feasibility under the push, how much of the
    # push the 1 s plan arrests, the height kept
    v_end = x_man[:, -1, 3:6] / float(run["params"].mass)
    z_min = x_man[:, :, 2].min(axis=1)
    sp = run["speeds"]
    v_red = np.where(sp > 1e-3, 1.0 - np.linalg.norm(v_end[:, :2], axis=1)
                     / np.maximum(sp, 1e-3), 1.0)
    rate = B * cfg.init_run_iters / run["t_steady"]
    print(f"first run (incl capture): {run['t_first']:.1f}s, steady: "
          f"{run['t_steady']*1e3:.0f} ms -> {rate:.0f} MPC solves/s")
    print(f"solved: {solved.mean()*100:.1f}%  plan keeps z>0.22: "
          f"{(z_min > 0.22).mean()*100:.1f}%")
    bins = {}
    for lo, hi in [(0, 1.0), (1.0, 1.8), (1.8, 2.5)]:
        msk = (sp >= lo) & (sp < hi) & solved
        if msk.any():
            bins[lo] = float(v_red[msk].mean())
            print(f"  |v| {lo:.1f}-{hi:.1f} m/s: planned speed reduction "
                  f"{v_red[msk].mean()*100:.0f}% over the horizon "
                  f"({msk.sum()} scenarios)")
    return dict(solved=float(solved.mean()), solves_per_s=rate,
                z_kept=float((z_min > 0.22).mean()), speed_reduction=bins)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else resolve_device(None)
    if "--closed-loop" in argv:
        return closed_loop_main(argv, device)
    args = [a for a in argv if not a.startswith("--")]
    report(plan(setup(int(args[0]) if args else 256, device), device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
