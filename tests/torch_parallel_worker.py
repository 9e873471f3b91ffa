"""One rank of tests/test_torch_parallel.py's launch of four ``gloo``
ranks on the CPU.

    python tests/torch_parallel_worker.py <dir> <rank> <world>

Joins the process group on a ``FileStore`` in <dir>, builds the
{scenario: 2, alpha: 2} mesh, reads <dir>/inputs.pt and writes
<dir>/rank<rank>.pt: the sharded ``batched_solve_step``, the
alpha-sharded gait update and the sharded closed loop, each gathered over
the scenario axis, and the messages of the two divisibility errors.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import dataclasses  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from bilevel_gait_gen_tpu_torch.parallel import multihost  # noqa: E402
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map  # noqa: E402


def gathered(tree, mesh, dim: int = 0):
    """Every ``DTensor`` of ``tree`` as its global value (gathered over the
    scenario axis along ``dim``)."""
    group = mesh["scenario"].get_group()
    return tree_map(lambda d: multihost.all_gather(d.to_local(), group, dim),
                    tree)


def error_of(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def main(d: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    multihost.initialize(f"file://{d}/store", world, rank, device="cpu")
    try:
        inp = torch.load(f"{d}/inputs.pt", weights_only=False)
        mesh = mesh_mod.make_mesh((2, 2), ("scenario", "alpha"),
                                  device="cpu")
        s, g, lp = inp["step"], inp["gait"], inp["loop"]
        step = mesh_mod.batched_solve_step(s["cfg"], s["params"])
        out = step(mesh_mod.shard_batch(s["states"], mesh),
                   mesh_mod.shard_batch(s["x0s"], mesh), s["t0"],
                   mesh_mod.shard_batch(s["feets"], mesh), s["x_des"])
        res = {"step": gathered(out, mesh)}
        # plain global tensors: each rank takes its scenarios' part
        upd = mesh_mod.alpha_sharded_gait_opt_update(g["cfg"], g["params"],
                                                     mesh)
        gargs = (g["states"], g["x0s"], g["t0"], g["feets"], g["x_des"])
        res["gait"] = gathered(upd(*gargs), mesh)
        three = dataclasses.replace(g["cfg"], ls_alphas=3)
        res["lanes_error"] = error_of(lambda: mesh_mod.
                                      alpha_sharded_gait_opt_update(
                                          three, g["params"], mesh)(*gargs))
        res["batch_error"] = error_of(lambda: mesh_mod.shard_batch(
            s["x0s"][:3], mesh))
        loop = mesh_mod.scenario_sharded_closed_loop(
            lp["model"], lp["params"], lp["cfg"], lp["wb_cfg"], lp["sim"],
            mesh, **lp["kw"])
        st, log = loop(lp["states"], lp["q0s"], lp["v0s"], lp["xds"])
        res["loop"] = (gathered(st, mesh), gathered(log, mesh, 1))
        torch.save(res, f"{d}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
