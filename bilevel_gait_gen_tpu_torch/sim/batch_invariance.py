"""Does one scenario's result depend on how many scenarios share its batch?

The closed loop (:mod:`sim.engine`) batches B scenarios through every
operation of a tick.  Each scenario's arithmetic should be its own: a
scenario run among 64 should give the same bits as among 128.  This module
runs an MPC tick of :func:`engine.period` stage by stage, through the
period's stage hook (``call(name, fn, *args)``, which may record or replace
a stage's inputs and outputs), and finds where that fails.

* :func:`loop_case`: the inputs of tests/test_parallel.py:171-199's loop
  (its small configuration, the settled stand, forward velocities in
  linspace(-0.1, 0.1), a cold solver state) for B scenarios;
* :func:`compare_stages`: an MPC tick at two batches, n scenarios (from
  scenario ``lo``) and all B, the larger fed each stage's inputs from the
  smaller run, so that every difference belongs to its stage alone; the
  largest per-scenario difference of each output;
* :func:`origin_ops`: inside one stage, every ATen operation whose inputs
  agree on the shared scenarios and whose outputs do not (recorded with a
  ``TorchDispatchMode``), with the line of the port that issued it;
  :func:`kernel_names` lists the device kernels ``torch.profiler`` shows
  for such operations, run again on their recorded arguments;
* :func:`instrumented_loop`: the loop's periods eagerly, recording its
  discrete choices (the contact latch, the RTI's step length and quality
  gate, the torque QP's sweeps) beside the log and the state at each MPC
  tick; :func:`first_parting` and :func:`flips` find where two such runs
  part and what flipped there.
"""
from __future__ import annotations

import dataclasses
import sys
from collections import defaultdict
from pathlib import Path
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

from bilevel_gait_gen_tpu_torch.control import wbqp
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
from bilevel_gait_gen_tpu_torch.mpc import gait as gait_mod
from bilevel_gait_gen_tpu_torch.mpc import solver as solver_mod
from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu_torch.sim import engine
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves, tree_map

LOOP = dict(n_ticks=40, control_dt=0.005, mpc_every=20)   # the test's loop
_PACKAGE = Path(__file__).resolve().parents[1]


def small_config() -> MPCConfig:
    """tests/test_parallel.py:23-25's configuration."""
    return MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                     samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                     init_run_iters=2, max_ls_iters=4, dt=0.05).validate()


@dataclasses.dataclass(frozen=True)
class Case:
    """What a tick holds fixed: the model and the configurations."""
    model: rbd.RobotModel
    params: srb.SRBParams
    cfg: MPCConfig
    wb_cfg: wbqp.WBQPConfig
    sim: engine.SimConfig
    control_dt: float

    def period(self, ls: engine.LoopState, x_des: torch.Tensor, *,
               ticks: int, gait: bool = False, call: Callable):
        """:func:`engine.period` from ``ls`` through the stage hook
        ``call`` (no schedule sync, as the test's loop)."""
        return engine.period(self.model, self.params, self.cfg, self.wb_cfg,
                             self.sim, x_des, ls, control_dt=self.control_dt,
                             ticks=ticks, gait=gait, contact_sync=False,
                             call=call)


def loop_case(batch: int, device, dtype=torch.float32):
    """tests/test_parallel.py:171-199's loop for ``batch`` scenarios:
    (Case, the cold solver state, q0s [B, nq], v0s [B, nv] with forward
    velocities in linspace(-0.1, 0.1, B), x_des [B, 12])."""
    scfg = small_config()
    model = a1.make_a1(device=device)
    q0 = torch.tensor(a1.stand_config(), device=device).to(dtype)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0, torch.zeros(model.nv, dtype=dtype,
                                                       device=device))
    feet0 = rbd.ee_positions(model, q0)
    traj = default_trajectory(scfg, gait_mod.make_trot(scfg, dtype=dtype,
                                                       device=device),
                              x0[None], feet0[None, :, :2])
    st1 = solver_mod.SolverState(traj=traj, ee_box=torch.tensor(
        [scfg.ee_box_size], dtype=dtype, device=device))
    sim = engine.SimConfig()
    v0s = torch.zeros(batch, model.nv, dtype=dtype, device=device)
    v0s[:, 0] = torch.linspace(-0.1, 0.1, batch, dtype=dtype, device=device)
    case = Case(model=model, params=params, cfg=scfg,
                wb_cfg=wbqp.WBQPConfig(), sim=sim,
                control_dt=LOOP["control_dt"])
    return (case, tree_map(lambda a: a.repeat_interleave(batch, 0), st1),
            engine.settled_stand(model, sim, q0).repeat(batch, 1), v0s,
            srb.manifold_to_tangent(x0).repeat(batch, 1))


def part(tree, lo: int, n: int):
    """Scenarios lo .. lo + n - 1 of a batch-first pytree."""
    return tree_map(lambda a: a[lo:lo + n] if a.dim() else a, tree)


def first(n: int, tree):
    """The first ``n`` scenarios of a batch-first pytree."""
    return part(tree, 0, n)


# ---------------------------------------------------------------------------
# stages at two batches
# ---------------------------------------------------------------------------

class Recorder:
    """A stage hook that records each stage's function, inputs and outputs
    (cloned).  With ``feed`` (a Recorder of a run of the n scenarios from
    ``lo``) each stage's inputs for those n scenarios are replaced by the
    ones that run saw, where they differ, so that a difference in a stage's
    outputs is its own."""

    def __init__(self, feed: "Recorder | None" = None, lo: int = 0):
        self.feed, self.lo = feed, lo
        self.fns, self.args, self.outs = {}, {}, {}

    def __call__(self, name: str, fn: Callable, *args):
        if self.feed is not None:
            args = tree_map(lambda a, s: _fed(a, s, self.lo), args,
                            self.feed.args[name])
        out = fn(*args)
        self.fns[name] = fn
        self.args[name] = tree_map(torch.clone, args)
        self.outs[name] = tree_map(torch.clone, out)
        return out


def _fed(a: torch.Tensor, small: torch.Tensor, lo: int) -> torch.Tensor:
    n = small.shape[0] if small.dim() else 0
    if not a.dim() or a.shape[0] == n or same_bits(a[lo:lo + n], small):
        return a
    return torch.cat([a[:lo], small, a[lo + n:]])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and values (NaN equal to NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = a.isnan()
        return bool(torch.equal(nan, b.isnan())
                    and torch.equal(a[~nan], b[~nan]))
    return bool(torch.equal(a, b))


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries finite in both (a float: inf where
    their NaN patterns differ; for integers and booleans, the count of
    unequal entries)."""
    if not a.is_floating_point():
        return float((a != b).sum())
    if not torch.equal(a.isnan(), b.isnan()):
        return float("inf")
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return float((a.double() - b.double()).abs()[fin].max())


class StageDiff(NamedTuple):
    name: str
    bitwise: bool
    max_diff: float           # over the stage's outputs
    per_output: list          # [(index, shape, max_diff)]


def compare_stages(case: Case, ls: engine.LoopState, x_des, n: int, *,
                   lo: int = 0, gait: bool = False):
    """The MPC tick that starts at ``ls`` (a period's start) for its batch B
    and for its n scenarios from ``lo``, each stage of the larger run fed
    the smaller run's inputs.  Returns ([StageDiff], the small run's
    Recorder, the large run's)."""
    small = Recorder()
    case.period(part(ls, lo, n), x_des[lo:lo + n], ticks=1, gait=gait,
                call=small)
    large = Recorder(feed=small, lo=lo)
    case.period(ls, x_des, ticks=1, gait=gait, call=large)
    diffs = []
    for name, out in small.outs.items():
        pairs = list(zip(tree_leaves(part(large.outs[name], lo, n)),
                         tree_leaves(out)))
        per = [(i, tuple(b.shape), 0.0 if same_bits(a, b) else
                max_diff(a, b)) for i, (a, b) in enumerate(pairs)]
        diffs.append(StageDiff(name, all(d == 0.0 for _, _, d in per),
                               max((d for _, _, d in per), default=0.0),
                               per))
    return diffs, small, large


# ---------------------------------------------------------------------------
# operations inside a stage
# ---------------------------------------------------------------------------

def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


_WHERE: dict[str, str | None] = {}


def _issuer() -> str:
    """The innermost line of the port (outside this module) on the Python
    stack: the line that issued the operation."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name not in _WHERE:
            path = Path(name).resolve()
            _WHERE[name] = (str(path.relative_to(_PACKAGE.parent))
                            if path.is_relative_to(_PACKAGE)
                            and path != Path(__file__).resolve() else None)
        if _WHERE[name] is not None:
            return f"{_WHERE[name]}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "?"


class _OpLog(TorchDispatchMode):
    """Records every ATen operation: its name, the line that issued it, and
    clones of its arguments (to compare them and to run the operation
    again) and of its tensor outputs."""

    def __init__(self):
        super().__init__()
        self.ops, self.where, self.calls, self.outs = [], [], [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls.append((func, tree_map_only(torch.Tensor, torch.clone,
                                               args),
                           tree_map_only(torch.Tensor, torch.clone, kwargs)))
        out = func(*args, **kwargs)
        self.ops.append(f"{func.overloadpacket.__name__}.{func._overloadname}")
        self.where.append(_issuer())
        self.outs.append([t.detach().clone() for t in _tensors(out)])
        return out

    def ins(self, i: int) -> list[torch.Tensor]:
        return _tensors(self.calls[i][1:])


def shared_part(big: torch.Tensor, small: torch.Tensor, block: int = 0):
    """The part of ``big`` (an operation's tensor at the larger batch) that
    belongs to the scenarios of ``small`` (the same at the smaller batch,
    whose scenarios are the larger batch's ``block``-th run of them):
    ``big`` itself when the shapes agree, else that slice along the one
    dimension that the batch scales (the first such dimension); None when no
    dimension does."""
    if big.shape == small.shape:
        return big
    if big.dim() != small.dim():
        return None
    for d, (a, b) in enumerate(zip(big.shape, small.shape)):
        if a != b:
            rest = all(x == y for k, (x, y) in enumerate(zip(big.shape,
                                                             small.shape))
                       if k != d)
            return (big.narrow(d, block * b, b)
                    if rest and b and a % b == 0 and (block + 1) * b <= a
                    else None)
    return None


def _same_bits_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``same_bits`` as a 0-dim bool tensor on the tensors' device (no
    synchronization); the shapes agree."""
    if a.is_floating_point():
        return ((a == b) | (a.isnan() & b.isnan())).all()
    return (a == b).all()


def _agree_t(bigs, smalls, unknown: bool, like: torch.Tensor, block: int):
    """Whether every tensor's shared part has the small run's bits, as a
    0-dim bool tensor; ``unknown`` where a part cannot be found."""
    flag = torch.ones((), dtype=torch.bool, device=like.device)
    if len(bigs) != len(smalls):
        return flag & unknown
    for a, b in zip(bigs, smalls):
        p = shared_part(a, b, block)
        if p is None or p.dtype != b.dtype:
            flag = flag & unknown
        elif p.numel():
            flag = flag & _same_bits_t(p, b).to(flag.device)
    return flag


class OriginOp(NamedTuple):
    index: int                # in the stage's sequence of operations
    op: str                   # aten name.overload
    where: str                # the port's line that issued it
    in_shapes: list           # at the larger batch
    max_diff: float           # its outputs' shared parts


def origin_ops(fn: Callable, args_small, args_large, limit: int = 20,
               block: int = 0):
    """Every operation of ``fn`` (run on both argument sets) whose inputs
    agree on the shared scenarios (the smaller run's, the larger run's
    ``block``-th run of as many) and whose outputs do not: the operations
    whose arithmetic depends on the batch.  Returns (their OriginOps, the
    number of operations run, the index where the two sequences of
    operations part or None, {index: (the small run's call, the large
    run's)} of the OriginOps, to run them again)."""
    logs = []
    for args in (args_small, args_large):
        with _OpLog() as log:
            fn(*tree_map(torch.clone, args))
        logs.append(log)
    s, b = logs
    n = min(len(s.ops), len(b.ops))
    parted = next((i for i in range(n) if s.ops[i] != b.ops[i]), None)
    if parted is None and len(s.ops) != len(b.ops):
        parted = n
    upto = n if parted is None else parted
    like = next(iter(_tensors(args_small)))
    ins_ok = [_agree_t(b.ins(i), s.ins(i), False, like, block)
              for i in range(upto)]
    outs_ok = [_agree_t(b.outs[i], s.outs[i], True, like, block)
               for i in range(upto)]
    if not upto:
        return [], len(b.ops), parted, {}
    origin = (torch.stack(ins_ok) & ~torch.stack(outs_ok)).cpu()
    found, calls = [], {}
    for i in torch.nonzero(origin).flatten().tolist()[:limit]:
        parts = [(shared_part(x, y, block), y)
                 for x, y in zip(b.outs[i], s.outs[i])]
        d = max((max_diff(x, y) for x, y in parts
                 if x is not None and not same_bits(x, y)), default=0.0)
        found.append(OriginOp(i, b.ops[i], b.where[i],
                              [tuple(t.shape) for t in b.ins(i)], d))
        calls[i] = (s.calls[i], b.calls[i])
    return found, len(b.ops), parted, calls


def kernel_names(calls: dict, tries: int = 4, reps: int = 5) -> dict:
    """{label: the device kernels ``torch.profiler`` shows for the call}
    for {label: (func, args, kwargs)}: each call run once untraced
    (handles, workspaces), then ``reps`` times in a profiler session of its
    own, so that every device event of the session is the call's.  A
    session can come back without the device's events (seen on the H100
    after other sessions of the process), so one warm-up session comes
    first and an empty session is tried again, up to ``tries`` times.
    Empty lists on the CPU."""
    out = {k: [] for k in calls}
    if not any(t.is_cuda for c in calls.values() for t in _tensors(c[1:])):
        return out
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(func, a, kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                func(*a, **kw)
            torch.cuda.synchronize()
        return list(dict.fromkeys(e.name for e in prof.events()
                                  if e.device_type == DeviceType.CUDA))
    for label, (func, a, kw) in calls.items():
        func(*a, **kw)
        torch.cuda.synchronize()
        if label == next(iter(calls)):
            session(func, a, kw)                      # warm-up
        for _ in range(tries):
            out[label] = session(func, a, kw)
            if out[label]:
                break
    return out


# ---------------------------------------------------------------------------
# the loop, period by period, with its discrete choices
# ---------------------------------------------------------------------------

class Choices(NamedTuple):
    """A loop's discrete choices, [T, B] each (alpha and solved NaN / True
    off the MPC ticks)."""
    mc: torch.Tensor          # [T, B, E] the latched contact
    alpha: torch.Tensor       # the RTI's step length
    solved: torch.Tensor      # the RTI's quality gate
    qp_iters: torch.Tensor    # the torque QP's sweeps taken
    qp_capped: torch.Tensor   # the torque QP stopped on its sweep cap


class _ChoiceCall:
    """A stage hook that keeps the outputs of the stages that hold a
    discrete choice, each call's in order, and passes the first output of
    each stage of ``perturb`` ({stage: fn}) through its fn (tick 0's)."""

    KEPT = ("latch_contact", "rti", "wbqp")

    def __init__(self, perturb=None):
        self.perturb = dict(perturb or {})
        self.seen = defaultdict(list)

    def __call__(self, name, fn, *args):
        out = fn(*args)
        if name in self.perturb:
            out = self.perturb.pop(name)(out)
        if name in self.KEPT:
            self.seen[name].append(out)
        return out


def instrumented_loop(case: Case, state0, q0, v0, x_des, *, n_ticks: int,
                      mpc_every: int, perturb=None):
    """``engine.closed_loop`` (no gait update, no schedule sync) eagerly,
    its periods run through a stage hook that keeps their discrete
    choices: (SimLog [T, B, ...], Choices, the LoopState at the start of
    each MPC period).  ``perturb`` ({stage: fn}) changes a stage's output
    on tick 0."""
    ls = engine.initial_state(case.model, case.cfg, case.sim, state0, q0, v0)
    call = _ChoiceCall(perturb)
    logs, starts = [], []
    for start in range(0, n_ticks, mpc_every):
        starts.append(ls)
        ls, log = case.period(ls, x_des, ticks=min(mpc_every,
                                                    n_ticks - start),
                              call=call)
        logs.append(log)
    log = engine.SimLog(*(torch.cat(f) for f in zip(*logs)))
    alpha = torch.full_like(log.cost, float("nan"))
    alpha[::mpc_every] = torch.stack([stats.alpha for _, stats
                                      in call.seen["rti"]])
    it = torch.stack([i for _, i in call.seen["wbqp"]])
    return (log, Choices(mc=torch.stack(call.seen["latch_contact"]),
                         alpha=alpha, solved=log.solved, qp_iters=it,
                         qp_capped=it >= case.wb_cfg.ipm_iters), starts)


def first_parting(q_a: torch.Tensor, q_b: torch.Tensor, bar: float = 1e-4):
    """The first tick, and the scenario of the largest gap there, at which
    two logs' q [T, B, nq] part by more than ``bar``: (tick, scenario, gap)
    or None."""
    d = (q_a.double() - q_b.double()).abs().amax(dim=-1)        # [T, B]
    over = (d > bar).any(dim=1)
    if not bool(over.any()):
        return None
    k = int(torch.nonzero(over)[0, 0])
    b = int(torch.argmax(d[k]))
    return k, b, float(d[k, b])


def flips(a: Choices, b: Choices, scenario: int, upto: int) -> list[str]:
    """The discrete choices of one scenario that differ between two runs
    at ticks 0..``upto``, in order: "tick k: what (run a / run b)"."""
    out = []
    for k in range(upto + 1):
        for e in range(a.mc.shape[-1]):
            x, y = bool(a.mc[k, scenario, e]), bool(b.mc[k, scenario, e])
            if x != y:
                out.append(f"tick {k}: contact latch of foot {e} ({x} / {y})")
        al, bl = float(a.alpha[k, scenario]), float(b.alpha[k, scenario])
        if al == al and al != bl:
            out.append(f"tick {k}: RTI step length ({al:g} / {bl:g})")
        s1, s2 = bool(a.solved[k, scenario]), bool(b.solved[k, scenario])
        if s1 != s2:
            out.append(f"tick {k}: RTI quality gate ({s1} / {s2})")
        c1, c2 = (bool(a.qp_capped[k, scenario]),
                  bool(b.qp_capped[k, scenario]))
        i1, i2 = int(a.qp_iters[k, scenario]), int(b.qp_iters[k, scenario])
        if c1 != c2:
            out.append(f"tick {k}: torque QP on its sweep cap ({c1} / {c2})")
        elif i1 != i2:
            out.append(f"tick {k}: torque QP sweeps ({i1} / {i2})")
    return out
