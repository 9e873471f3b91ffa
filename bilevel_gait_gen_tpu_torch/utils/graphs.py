"""CUDA graphs of the port's loops: the counterpart of ``jax.jit`` on the
bench path.

``bench.py`` runs a cadence cycle (``FREQ - 1`` real-time iterations and a
gait update) as one jitted dispatch.  Run eagerly, the same cycle is some
50,000 kernel launches, and the card waits on the host between them.
:class:`Graphed` captures such a function once as one
``torch.cuda.CUDAGraph`` and replays it: one launch from the host a call.

Arguments and results are pytrees: tensors inside tuples (named ones
included), lists, dicts and dataclasses (``SolverState``,
``GaitOptResult``); anything else is a constant of the capture.  The
graph reads its inputs from static copies of the example arguments and
writes its results to the tensors the captured call returned, so each
replay overwrites the last one's results.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from bilevel_gait_gen_tpu_torch.ops import kernels


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied to the tensors of ``tree`` (and to the tensors at the
    same places of the trees ``rest``), rebuilt with the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        parts = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        # a NamedTuple takes its fields one by one
        return type(tree)(*parts) if hasattr(tree, "_fields") else \
            type(tree)(parts)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in the order :func:`tree_map` visits them
    (nothing is rebuilt on the way)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        parts = tree
    elif isinstance(tree, dict):
        parts = tree.values()
    else:
        return []
    return [leaf for part in parts for leaf in tree_leaves(part)]


def copy_into(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst``, a tree of the same
    structure and shapes."""
    d, s = tree_leaves(dst), tree_leaves(src)
    if len(d) != len(s):
        raise ValueError(f"{len(s)} tensors for {len(d)} static buffers")
    for a, b in zip(d, s):
        if a.shape != b.shape:
            raise ValueError(f"shape {tuple(b.shape)} for a static buffer of "
                             f"shape {tuple(a.shape)}")
        a.copy_(b)


class Graphed:
    """``fn(*args)`` captured once as a CUDA graph, replayed at each call.

    ``fn`` runs twice on a side stream first (this builds the
    kernels and creates the cuBLAS and cuSOLVER handles and workspaces
    before the capture), then once under capture over static copies of
    ``example_args`` (:attr:`args`).  A call copies the arguments it is
    given into those buffers (an argument that *is* its static buffer is
    not copied), replays the graph and returns the captured results
    (:attr:`out`).

    ``carry`` maps an argument's index to a function of the results: after
    ``fn``, the graph copies that part of the results into the argument's
    static buffers, so that the argument chains from replay to replay
    without a copy from the host side (``carry={0: lambda out: out[0]}``
    for a function that returns its new state first).

    Every tensor of ``example_args`` must lie on the card: a CPU tensor
    raises.  An error during the capture raises too; nothing falls back to
    the eager call.  :attr:`captured_launches` holds the launches of each
    hand-written kernel made during the capture (the wrappers' counters do
    not move when the graph replays); :attr:`replays` counts the replays.
    """

    def __init__(self, fn: Callable, *example_args,
                 carry: dict[int, Callable] | None = None):
        leaves = tree_leaves(example_args)
        if not leaves:
            raise ValueError("Graphed needs at least one tensor argument")
        for t in leaves:
            if t.device.type != "cuda":
                raise ValueError(f"Graphed captures CUDA work; an argument "
                                 f"lies on {t.device}")
        self.fn = fn
        self.args = tree_map(lambda t: t.detach().clone(), example_args)
        self.carry = dict(carry or {})
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(2):
                fn(*self.args)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = fn(*self.args)
                for i, pick in self.carry.items():
                    copy_into(self.args[i], pick(self.out))
        except Exception as exc:
            exc.add_note(f"while capturing {getattr(fn, '__name__', fn)} "
                         "as a CUDA graph")
            raise
        after = kernels.launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.replays = 0

    def __call__(self, *args):
        if args:
            if len(args) != len(self.args):
                raise TypeError(f"{len(args)} arguments for "
                                f"{len(self.args)}")
            for a, static in zip(args, self.args):
                if a is not static:
                    copy_into(static, a)
        self.graph.replay()
        self.replays += 1
        return self.out

    def replayed_launches(self) -> dict[str, int]:
        """The kernels' launches made by the replays so far."""
        return {k: v * self.replays for k, v in self.captured_launches.items()}

    def close(self) -> None:
        """Free the graph and its memory pool (once nothing else holds its
        results)."""
        self.graph.reset()
        self.out = self.args = None


def _same_bits(a, b) -> bool:
    """Every tensor of ``a`` equal to its place in ``b`` bit for bit (NaNs
    included)."""
    def bits(t):
        return {torch.float32: torch.int32,
                torch.float64: torch.int64}.get(t.dtype)
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.view(bits(x)), y.view(bits(y))) if bits(x) else
        torch.equal(x, y) for x, y in zip(la, lb))


class FirstUseGraphs:
    """Named functions run as the JAX package's scripts run their
    ``jax.jit``-ed ones: ``graphs(name, fn, *args)`` calls ``fn(*args)``
    eagerly on CPU tensors; on the card the first call of a name runs
    ``fn`` eagerly, captures it as a :class:`Graphed`, replays it and
    raises unless the replay equals the eager result bit for bit; later
    calls of the name replay that graph on their arguments (``fn`` is then
    not looked at).  Python scalars that ``fn`` closes over are constants
    of the capture, so whatever changes between calls is an argument.

    :attr:`first_args` holds clones of each first call's arguments,
    :attr:`eager_ms` its eager wall ms, :attr:`compared` the number of
    outputs held bit for bit, and :attr:`graphs` the graphs, which
    :meth:`close` frees."""

    def __init__(self, device):
        self.graphed = torch.device(device).type == "cuda"
        self.graphs: dict[str, Graphed] = {}
        self.first_args: dict[str, tuple] = {}
        self.eager_ms: dict[str, float] = {}
        self.compared: dict[str, int] = {}

    def __call__(self, name: str, fn: Callable, *args):
        if not self.graphed:
            return fn(*args)
        g = self.graphs.get(name)
        if g is not None:
            return g(*args)
        self.first_args[name] = tree_map(torch.clone, args)
        torch.cuda.synchronize()
        t_in = time.perf_counter()
        eager = fn(*args)
        torch.cuda.synchronize()
        self.eager_ms[name] = (time.perf_counter() - t_in) * 1e3
        g = self.graphs[name] = Graphed(fn, *args)
        out = g(*args)
        if not _same_bits(out, eager):
            raise RuntimeError(f"the graph of {name} differs from its eager "
                               "call")
        self.compared[name] = len(tree_leaves(out))
        return out

    def close(self) -> None:
        """Free the graphs (once nothing holds their results)."""
        for g in self.graphs.values():
            g.close()
        self.graphs = {}
