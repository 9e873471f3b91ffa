#!/usr/bin/env python3
"""Multi-process smoke run of the PyTorch port (port of
scripts/multihost_demo.py).

Spawns NUM_PROC worker processes that join one ``gloo`` process group on a
``FileStore`` in a temporary directory (no port is bound), build the global
scenario mesh, assemble their local batches into one global batch, run one
sharded batched MPC step (``parallel/mesh.batched_solve_step``: each rank
solves its shard; on the card a CUDA graph captured at the first call) and
gather the costs for the mean over the global batch.  On one card the
workers share it: NCCL refuses two ranks on one device, so the group is
``gloo``, whose gathers go through host memory.

Usage: python scripts/torch_multihost_demo.py [--cpu]
       (workers are re-invoked with WORKER=i STORE=<path>)
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NUM_PROC = 2
B_LOCAL = 2          # scenarios per process


def small_config():
    """scripts/multihost_demo.py's configuration."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                     samples_per_stance=3, ee_node_start=1, ipm_iters=8,
                     max_ls_iters=3).validate()


def local_batch(cfg, pid: int, device, dtype=None):
    """This process's batch (multihost_demo.py:46-58): (params, states,
    x0s, feets, x_des [12]), B_LOCAL copies of the stand, the measured
    states moved by 0.001 (pid + 1).  ``device`` None means the card."""
    import torch
    from bilevel_gait_gen_tpu_torch import resolve_device
    from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
    from bilevel_gait_gen_tpu_torch.mpc import gait, solver
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    dtype = dtype or torch.float32
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
    st = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=device))
    states = tree_map(lambda a: a.repeat_interleave(B_LOCAL, 0), st)
    x0s = x0.expand(B_LOCAL, -1) + 0.001 * (pid + 1)
    feets = feet0.expand(B_LOCAL, -1, -1).contiguous()
    return params, states, x0s, feets, srb.manifold_to_tangent(x0)


def worker(pid: int, store: str, device) -> None:
    import torch.distributed as dist
    from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod
    from bilevel_gait_gen_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{store}", NUM_PROC, pid, device=device,
                         backend="gloo")
    try:
        mesh = multihost.global_mesh(device=device)
        cfg = small_config()
        params, states, x0s, feets, x_des = local_batch(cfg, pid, device)
        g_states, g_x0s, g_feets = (
            multihost.host_local_batch_to_global(a, mesh)
            for a in (states, x0s, feets))
        step = mesh_mod.batched_solve_step(cfg, params)
        out, stats = step(g_states, g_x0s, 0.0, g_feets, x_des)
        # cross-process reduction: every rank gathers the global costs
        costs = multihost.all_gather(stats.cost.to_local(),
                                     mesh["scenario"].get_group())
        step.close()
        print(f"[worker {pid}] global batch {costs.shape[0]} scenarios, "
              f"mean cost {float(costs.mean()):.2f}, ranks "
              f"{dist.get_world_size()}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "WORKER" in os.environ:
        worker(int(os.environ["WORKER"]), os.environ["STORE"],
               "cpu" if "--cpu" in argv else None)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for pid in range(NUM_PROC):
            env = dict(os.environ, WORKER=str(pid),
                       STORE=os.path.join(tmp, "store"), PYTHONPATH=ROOT)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *argv], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            for p in procs:
                out = p.communicate(timeout=600)[0]
                print(out, end="", flush=True)
        finally:
            for p in procs:
                p.kill()
    codes = [p.returncode for p in procs]
    print("worker exit codes:", codes)
    if any(c != 0 for c in codes):
        return 1
    print("MULTIHOST OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
