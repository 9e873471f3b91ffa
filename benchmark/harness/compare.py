"""The comparison that decides ``correct``: the program's answers, rows of
its own outputs, set against the plain reference (``benchmark/reference``)
run from the same inputs in float64 on the same device.

The reference follows the program answer by answer from the program's own
state (the input state of each sampled answer), since a float32
interior-point method reaches another valid iterate wherever an order of
summation differs, and a chain of solves or a closed loop amplifies that;
the start (the problem the program was handed) is compared on its own.
Every number is the worst over the sampled answers, and passes where it is
at most its limit (``limits/<workload>.json``).  The control, the
reference put in the program's place in TF32, is judged by the same
numbers (``benchmark/control.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchmark.reference import (config, engine, gait, pdip, solver, srb,
                                 trajectory, wbqp)

# the reference's classes by name, to carry a tree of the program's into
# the reference's own types
REF_CLASSES = {c.__name__: c for c in (
    solver.SolverState, trajectory.Trajectory, gait.GaitSchedule,
    pdip.QPSolution, engine.LoopState, srb.SRBParams)}


def to_ref(tree, dtype: torch.dtype, device):
    """A tree of the program's (dataclasses, named tuples, tuples, tensors)
    in the reference's classes, its floating tensors cast to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(device)
        return t.to(dtype) if t.is_floating_point() else t.clone()
    name = type(tree).__name__
    if dataclasses.is_dataclass(tree):
        return REF_CLASSES[name](**{
            f.name: to_ref(getattr(tree, f.name), dtype, device)
            for f in dataclasses.fields(tree)})
    if hasattr(tree, "_fields"):
        return REF_CLASSES[name](*(to_ref(v, dtype, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_ref(v, dtype, device) for v in tree)
    return tree


def rows(tree, idx: torch.Tensor, dim: int = 0):
    """The rows ``idx`` of every tensor of a tree (scalars as they are)."""
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map

    def pick(t):
        return t if t.ndim <= dim else t.index_select(dim, idx.to(t.device))
    return tree_map(pick, tree)


def stack(trees):
    """Trees of one structure concatenated along their first axis (a
    scalar tensor, such as a loop's tick, is the first tree's)."""
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    return tree_map(lambda *ts: torch.cat(ts) if ts[0].ndim else ts[0],
                    *trees)


def ref_mpc_config(fields: dict) -> config.MPCConfig:
    return config.MPCConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in fields.items()}).validate()


def ref_wb_config(fields: dict) -> wbqp.WBQPConfig:
    return wbqp.WBQPConfig(**fields)


def ref_sim_config(fields: dict) -> engine.SimConfig:
    return engine.SimConfig(**fields)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in TF32 (the control) or in full float32, restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(|b|, 1) over finite pairs; inf where one side is
    finite and the other is not."""
    a, b = a.double().cpu(), b.double().cpu()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if bool((fa != fb).any()):
        return float("inf")
    if not bool(fa.any()):
        return 0.0
    d = torch.abs(a[fa] - b[fb]) / torch.clamp_min(torch.abs(b[fb]), 1.0)
    return float(d.max())


def abs_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, inf where either side is not finite."""
    a, b = a.double().cpu(), b.double().cpu()
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        return float("inf")
    return float(torch.amax(torch.abs(a - b))) if a.numel() else 0.0


def q75(values) -> float:
    """The upper quartile of the sampled answers' gaps (inclusive: within
    the values' range); a gap that half the answers share shows, one that a
    few chaotic answers show does not."""
    import statistics
    values = list(values)
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=4, method="inclusive")[2])


def count_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """How many entries of two bool tensors differ."""
    return float((a.cpu() != b.cpu()).sum())


def judged(prog: dict, limits: dict) -> tuple[list, list]:
    """(checks, problems): each number the limits file names, with its
    limit; a number the run did not read is a problem."""
    checks, problems = [], []
    for name, limit in limits.items():
        if name in prog:
            checks.append((name, prog[name], limit))
        else:
            problems.append(f"no reading {name}")
    return checks, problems
