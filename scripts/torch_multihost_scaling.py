#!/usr/bin/env python3
"""Multi-process weak-scaling curve of the batched MPC solve on the PyTorch
port (port of scripts/multihost_scaling.py).

Each worker process holds a fixed local scenario batch (B_LOCAL); N
processes join one ``gloo`` process group (a ``FileStore`` in a temporary
directory: no port is bound), build the global scenario mesh and run the
sharded chain of STEPS batched RTIs together
(``parallel/mesh.batched_solve_chain``: one call a repetition, one CUDA
graph on the card).  Rank 0 times the repetitions between two barriers.
On the CPU each worker is pinned to a core of its own and runs one thread,
so that the curve measures the processes' overhead, not shrinking cores;
on the card the workers share it.  The parent sweeps N and writes

    {"rows": [{"n_procs": N, "global_batch": B, "solves_per_s": S,
               "efficiency": S / (N * S_1)}, ...], ...}

to the path it is given (default: ``torch_scaling.json`` in the temporary
directory; never the repository's SCALING.json, the JAX package's record).

Usage: python scripts/torch_multihost_scaling.py [--cpu] [--out=PATH]
       [--ns=1,2,4] [--steps=30] [--reps=3]
       (workers re-invoked with WORKER=i NPROC=n STORE=<path>)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B_LOCAL = 4          # scenarios per process (weak scaling)
STEPS = 30           # RTIs a timed repetition
REPS = 3


def options(argv) -> dict:
    opt = dict(cpu="--cpu" in argv, ns=(1, 2, 4), steps=STEPS, reps=REPS,
               out=os.path.join(tempfile.gettempdir(), "torch_scaling.json"))
    for a in argv:
        if a.startswith("--ns="):
            opt["ns"] = tuple(int(n) for n in a[5:].split(","))
        elif a.startswith("--steps="):
            opt["steps"] = int(a[8:])
        elif a.startswith("--reps="):
            opt["reps"] = int(a[7:])
        elif a.startswith("--out="):
            opt["out"] = a[6:]
    return opt


def worker(pid: int, nproc: int, store: str, opt: dict) -> None:
    import torch
    import torch.distributed as dist
    from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod
    from bilevel_gait_gen_tpu_torch.parallel import multihost
    from torch_multihost_demo import local_batch, small_config

    device = "cpu" if opt["cpu"] else None
    if opt["cpu"]:
        torch.set_num_threads(1)
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[pid % len(cores)]})
    multihost.initialize(f"file://{store}", nproc, pid, device=device,
                         backend="gloo")
    try:
        mesh = multihost.global_mesh(device=device)
        cfg = small_config()
        params, states, x0s, feets, x_des = local_batch(cfg, pid, device)
        g_states, g_x0s, g_feets = (
            multihost.host_local_batch_to_global(a, mesh)
            for a in (states, x0s, feets))
        chain = mesh_mod.batched_solve_chain(cfg, params, opt["steps"] - 1)
        sync = torch.cuda.synchronize if not opt["cpu"] else (lambda: None)
        out, stats = chain(g_states, g_x0s, 0.0, g_feets, x_des)  # capture
        sync()
        dist.barrier()
        tic = time.perf_counter()
        for _ in range(opt["reps"]):
            out, stats = chain(out, g_x0s, 0.0, g_feets, x_des)
        sync()
        dist.barrier()
        dt_s = time.perf_counter() - tic
        chain.close()
        rate = opt["reps"] * opt["steps"] * B_LOCAL * nproc / dt_s
        if pid == 0:
            print("RESULT " + json.dumps(
                {"n_procs": nproc, "solves_per_s": rate,
                 "global_batch": B_LOCAL * nproc}), flush=True)
    finally:
        dist.destroy_process_group()


def run_n(nproc: int, argv) -> dict:
    """One run of ``nproc`` workers: rank 0's RESULT row."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for pid in range(nproc):
            env = dict(os.environ, WORKER=str(pid), NPROC=str(nproc),
                       STORE=os.path.join(tmp, "store"), PYTHONPATH=ROOT)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *argv], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"a {nproc}-process run failed:\n"
                           + "\n".join(outs))
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"no RESULT from the {nproc}-process run:\n{outs[0]}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opt = options(argv)
    if "WORKER" in os.environ:
        worker(int(os.environ["WORKER"]), int(os.environ["NPROC"]),
               os.environ["STORE"], opt)
        return 0
    ns = [n for n in opt["ns"]
          if not opt["cpu"] or n <= len(os.sched_getaffinity(0))]
    rows, base = [], None
    for n in ns:
        r = run_n(n, argv)
        if base is None:
            base = r["solves_per_s"]
        r["efficiency"] = r["solves_per_s"] / (n * base)
        rows.append(r)
        print(f"n_procs={n} solves/s={r['solves_per_s']:.1f} "
              f"efficiency={r['efficiency']:.3f}", flush=True)
    with open(opt["out"], "w") as f:
        json.dump({"rows": rows, "b_local": B_LOCAL, "steps": opt["steps"],
                   "reps": opt["reps"],
                   "device": "cpu" if opt["cpu"] else "cuda",
                   "note": "weak scaling, one process a rank, gloo "
                           "scenario mesh"}, f, indent=1)
    print(f"wrote {opt['out']}")
    print("SCALING OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
