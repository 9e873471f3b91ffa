"""Device-mesh scaling: scenario-batched MPC over ``torch.distributed``
(port of ``bilevel_gait_gen_tpu/parallel/mesh.py``, whose docstring gives
the two axes: ``scenario``, independent MPC problems, and ``alpha``, the gait
update's line-search lanes).

The mesh is a ``DeviceMesh`` over the ranks of the process group.  Where the
JAX module places arrays with a ``NamedSharding``, a batch here is a
``DTensor`` sharded on dimension 0 over ``scenario`` and replicated over the
other axes (:func:`shard_batch`).  Inside, every function works on plain
local tensors: its inputs' ``.to_local()`` on the way in,
``DTensor.from_local`` with the same placements on the way out, so the
solver, the kernels and the CUDA graphs never see a ``DTensor``.  A plain
tensor handed to a sharded function is the global batch, of which each rank
takes its part; a plain tensor handed to a ``batched_*`` function is this
rank's batch, and the results are plain too.  Arguments that the JAX
functions share between scenarios (``in_axes=None``: ``t0``, ``x_des``) are
a number or a 0-d tensor and a [12] tensor.

The JAX module's ``jax.jit(jax.vmap(f))`` is a call of the batched function:
eagerly on CPU tensors, and on the card captured as a CUDA graph at its
first call for each set of argument shapes (``utils/graphs.FirstUseGraphs``,
which holds the replay to that eager call bit for bit) and replayed; the
results are copied out of the graph's buffers.  The one exception is
:func:`alpha_sharded_gait_opt_update`, which runs eagerly: its gather
between the lane solves and the choice of the winner is a collective, which
a graph cannot hold on a ``gloo`` group.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc import bilevel as bilevel_mod
from bilevel_gait_gen_tpu_torch.mpc import solver as solver_mod
from bilevel_gait_gen_tpu_torch.parallel import multihost
from bilevel_gait_gen_tpu_torch.sim import engine as engine_mod
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch.utils.consts import filled
from bilevel_gait_gen_tpu_torch.utils.graphs import (
    FirstUseGraphs, tree_leaves, tree_map)


def make_mesh(axis_sizes: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("scenario",), *,
              device=None) -> DeviceMesh:
    """A mesh over all ranks (default: a 1-D scenario axis), on the card
    unless ``device`` names the CPU.  It needs a process group
    (``multihost.initialize``, or ``multihost.one_rank_group()`` for one
    process)."""
    if axis_sizes is None:
        return multihost.global_mesh(axis_names[0], device=device)
    return multihost.device_mesh(axis_sizes, axis_names, device)


def _local_part(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                dim: int = 0) -> torch.Tensor:
    """This rank's part along ``dim`` of a global batch: a ``DTensor``'s
    local tensor, or its slice of a plain tensor."""
    if isinstance(x, DTensor):
        return x.to_local()
    n, i = mesh[axis].size(), mesh[axis].get_local_rank()
    if x.shape[dim] % n:
        raise ValueError(f"a batch of {x.shape[dim]} does not divide over "
                         f"the {n} ranks of the '{axis}' axis")
    return x.chunk(n, dim)[i]


def shard_batch(tree, mesh: DeviceMesh, axis: str = "scenario"):
    """A batched tree (the same global batch on every rank) as ``DTensor``s
    sharded on dimension 0 over ``axis``, replicated over the mesh's other
    axes."""
    return multihost.host_local_batch_to_global(
        tree_map(lambda x: _local_part(x, mesh, axis), tree), mesh, axis)


def _unwrap(args):
    """The arguments' local tensors, and the mesh and placements of their
    first ``DTensor`` (None for plain tensors)."""
    layout = None
    for leaf in tree_leaves(args):
        if isinstance(leaf, DTensor):
            layout = (leaf.device_mesh, leaf.placements)
            break
    local = tree_map(lambda x: x.to_local() if isinstance(x, DTensor)
                     else x, args)
    return local, layout


def _wrap(out, layout):
    if layout is None:
        return out
    mesh, placements = layout
    return tree_map(lambda x: DTensor.from_local(x, mesh, placements,
                                                 run_check=False), out)


def _scenario_args(x0s: torch.Tensor, t0, x_des: torch.Tensor):
    """``t0`` [B] and ``x_des`` [B, 12] for the B scenarios of ``x0s``
    from the shared ``t0`` (a number or a 0-d tensor) and ``x_des`` [12]."""
    B, dtype, dev = x0s.shape[0], x0s.dtype, x0s.device
    return (filled(t0, (B,), dtype, dev),
            x_des.to(dtype).expand(B, -1).contiguous())


class BatchedCall:
    """``fn`` over a scenario batch as the JAX module's ``jax.jit(jax.vmap(
    fn))``: eager on CPU tensors; on the card a CUDA graph captured at the
    first call for each set of argument shapes and dtypes, replayed after.
    ``DTensor`` arguments are unwrapped and the results wrapped back with
    the placements of the first one; a number argument becomes a 0-d tensor
    (an argument of the graph, not a constant of its capture).
    :meth:`close` frees the graphs."""

    def __init__(self, fn: Callable, name: str):
        self.fn, self.name = fn, name
        self.graphs: FirstUseGraphs | None = None

    def __call__(self, *args):
        local, layout = _unwrap(args)
        like = tree_leaves(local)[0]
        local = tuple(torch.tensor(float(a), dtype=like.dtype,
                                   device=like.device)
                      if isinstance(a, (int, float)) else a for a in local)
        leaves = tree_leaves(local)
        if self.graphs is None:
            self.graphs = FirstUseGraphs(like.device)
        key = (self.name, tuple((tuple(t.shape), t.dtype) for t in leaves))
        out = self.graphs(repr(key), self.fn, *local)
        if self.graphs.graphed:
            out = tree_map(torch.clone, out)
        return _wrap(out, layout)

    def close(self) -> None:
        if self.graphs is not None:
            self.graphs.close()


def batched_solve_step(cfg: MPCConfig, params: SRBParams) -> BatchedCall:
    """The real-time iteration over a scenario batch: fn(states, x0s, t0,
    ee0s, x_des) -> (states, stats).  Under a sharded batch each rank
    solves its shard."""
    def step(states, x0s, t0, ee0s, x_des):
        t0b, xdb = _scenario_args(x0s, t0, x_des)
        return solver_mod.solve_step(cfg, params, states, x0s, t0b, ee0s,
                                     xdb)

    return BatchedCall(step, "solve_step")


def batched_solve_chain(cfg: MPCConfig, params: SRBParams,
                        n_steps: int) -> BatchedCall:
    """``n_steps`` chained batched RTIs (at t0 + k dt) and one more, as one
    call (the JAX ``lax.scan`` chain; one CUDA graph on the card):
    fn(states, x0s, t0, ee0s, x_des) -> (states, last stats)."""
    def chain(states, x0s, t0, ee0s, x_des):
        t0b, xdb = _scenario_args(x0s, t0, x_des)
        for k in range(n_steps):
            states, _ = solver_mod.solve_step(cfg, params, states, x0s,
                                              t0b + k * cfg.dt, ee0s, xdb)
        return solver_mod.solve_step(cfg, params, states, x0s,
                                     t0b + n_steps * cfg.dt, ee0s, xdb)

    return BatchedCall(chain, f"solve_chain_{n_steps}")


def batched_gait_opt_update(cfg: MPCConfig,
                            params: SRBParams) -> BatchedCall:
    """The full bilevel update (QP gradient -> projection QP -> alpha line
    search) over a scenario batch, every scenario in lockstep with its
    ``ls_alphas`` lanes here: fn(states, x0s, t0, ee0s, x_des) ->
    GaitOptResult."""
    def upd(states, x0s, t0, ee0s, x_des):
        t0b, xdb = _scenario_args(x0s, t0, x_des)
        return bilevel_mod.gait_opt_update(cfg, params, states, x0s, t0b,
                                           ee0s, xdb)

    return BatchedCall(upd, "gait_opt_update")


def alpha_sharded_gait_opt_update(cfg: MPCConfig, params: SRBParams,
                                  mesh: DeviceMesh,
                                  scenario_axis: str = "scenario",
                                  alpha_axis: str = "alpha") -> Callable:
    """The bilevel update with the line-search lanes sharded over the
    mesh's ``alpha`` axis and the scenarios over ``scenario``: each rank
    solves its scenarios' slice of the lanes, and the lanes' objectives
    cross the alpha axis in one gather (``cfg.ls_alphas`` must be divisible
    by the alpha axis's size).

    Returns fn(states, x0s, t0, ee0s, x_des) -> GaitOptResult.  states, x0s
    and ee0s are global batches (``DTensor``s or plain tensors), sharded
    over ``scenario`` and replicated over ``alpha``; the result's tensors
    are ``DTensor``s of the same placements (after the gather every alpha
    rank holds the same result, so one copy stands for the axis).  Runs
    eagerly (the gather is a collective)."""
    group = mesh[alpha_axis].get_group()

    def fn(states, x0s, t0, ee0s, x_des):
        st, x0, ee0 = (tree_map(lambda a: _local_part(a, mesh, scenario_axis),
                                a) for a in (states, x0s, ee0s))
        t0, x_des = (a.to_local() if isinstance(a, DTensor) else a
                     for a in (t0, x_des))
        t0b, xdb = _scenario_args(x0, t0, x_des)
        res = bilevel_mod.gait_opt_update(cfg, params, st, x0, t0b, ee0, xdb,
                                          ls_group=group)
        return multihost.host_local_batch_to_global(res, mesh, scenario_axis)

    return fn


def batched_initial_run(cfg: MPCConfig, params: SRBParams) -> BatchedCall:
    """``solver.create_initial_run`` over a scenario batch:
    fn(states, x0s, ee0s, x_des, t0=0.0) -> (states, stats)."""
    def run(states, x0s, ee0s, x_des, t0=0.0):
        t0b, xdb = _scenario_args(x0s, t0, x_des)
        return solver_mod.create_initial_run(cfg, params, states, x0s, ee0s,
                                             xdb, t0b)

    return BatchedCall(run, "initial_run")


def scenario_sharded_closed_loop(model, params, cfg: MPCConfig, wb_cfg,
                                 sim, mesh: DeviceMesh, *, n_ticks: int,
                                 control_dt: float, mpc_every: int,
                                 scenario_axis: str = "scenario") -> Callable:
    """The whole closed loop (``sim/engine.closed_loop``: penalty physics,
    the whole-body QP, MPC RTIs) sharded over scenarios, with no
    communication between them.

    Returns f(states, q0s, v0s, x_des_tans) -> (states, SimLog): every
    argument a global batch on dimension 0; the states sharded on dimension
    0 and the log, whose fields are [n_ticks, B, ...], on dimension 1 over
    ``scenario_axis``.  Each rank's loop captures its own graphs on the
    card."""
    def fn(states, q0s, v0s, x_des_tans):
        st, q0, v0, xd = (tree_map(lambda a: _local_part(a, mesh,
                                                         scenario_axis), a)
                          for a in (states, q0s, v0s, x_des_tans))
        st2, log = engine_mod.closed_loop(
            model, params, cfg, wb_cfg, sim, st, q0, v0, xd,
            n_ticks=n_ticks, control_dt=control_dt, mpc_every=mpc_every)
        return (multihost.host_local_batch_to_global(st2, mesh,
                                                     scenario_axis),
                tree_map(lambda x: DTensor.from_local(
                    x, mesh, multihost.placements(mesh, scenario_axis, 1),
                    run_check=False), log))

    return fn
