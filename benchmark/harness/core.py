"""What every cell's run shares: the cell's files found by name, the card
checked, the caches kept in the checkout, the loops run as CUDA graphs,
and the one JSON line printed at the end.

A run is ``python3 benchmark/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>``: ``BENCHMARK.json`` names the cell's configuration and
traffic; ``configs/<config>.json`` holds the deployment's settings,
``traffic/<traffic>.json`` the traffic's parameters and its ``kind``, the
generator in ``kinds/<kind>.py`` that drives it, and
``limits/<workload>.json`` the limits of the numbers that decide
``correct``.  Each per-layer metric is read by ``metrics/<name>.py`` from
the traced run's record.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "bilevel_gait_gen_tpu")


class NoCard(RuntimeError):
    """The card the cell asks for is not there."""


@dataclasses.dataclass
class Ctx:
    """One run: the cell, its files' contents and the run's arguments."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    spec: dict           # BENCHMARK.json
    cell: dict           # its entry of ``workloads``
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    limits: dict         # limits/<workload>.json
    device: str = "cuda"
    t_start: float = 0.0
    control: bool = False   # also read the control (benchmark/control.py)

    @property
    def chips(self) -> int:
        return int(self.cell["chips"])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_ctx(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda") -> Ctx:
    """The cell's files, found by the names in ``BENCHMARK.json``."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(there are {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    return Ctx(workload=workload, seed=seed, seconds=seconds, trace=trace,
               spec=spec, cell=cell, config=config, traffic=traffic,
               limits=limits, device=device, t_start=t_start)


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (metric files carry a dot in
    their names, which ``import`` does not take), loaded once a process."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def kind_module(ctx: Ctx):
    kind = ctx.traffic["kind"]
    return load_module(BENCH / "kinds" / f"{kind}.py", f"bench_kind_{kind}")


def set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that a checkout's first run builds and later runs find it.  The port
    builds its own kernels into ``bilevel_gait_gen_tpu_torch/_build/``;
    these name PyTorch's and Triton's, should anything reach them."""
    cache = BENCH / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def require_card(chips: int) -> str:
    """The card's name; raises :class:`NoCard` without CUDA or with fewer
    cards than the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"asks for {chips}")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> list[str]:
    """The top-level names of ``FORBIDDEN`` that the process has loaded,
    compared whole (``bilevel_gait_gen_tpu_torch`` is not
    ``bilevel_gait_gen_tpu``)."""
    top = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


class Eager:
    """The interface of the port's ``utils/graphs.Graphed``, run op by op:
    the loops of a run on the CPU (the benchmark's own tests)."""

    def __init__(self, fn, *args, carry=None):
        from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
        self.fn = fn
        self.args = list(tree_map(lambda t: t.clone(), list(args)))
        self.carry = dict(carry or {})
        self.out = None
        self.captured_launches = {}

    def __call__(self, *args):
        from bilevel_gait_gen_tpu_torch.utils.graphs import copy_into
        for i, a in enumerate(args):
            if a is not self.args[i]:
                copy_into(self.args[i], a)
        self.out = self.fn(*self.args)
        for i, pick in self.carry.items():
            copy_into(self.args[i], pick(self.out))
        return self.out

    def close(self) -> None:
        self.out = self.args = None


def loop(device: str, fn, *args, carry=None):
    """``fn`` over ``args`` captured as a CUDA graph by the port's
    ``Graphed`` on the card; eagerly elsewhere."""
    if device == "cuda":
        from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
        return Graphed(fn, *args, carry=carry)
    return Eager(fn, *args, carry=carry)


def clone_tree(tree):
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    return tree_map(lambda t: t.clone(), tree)


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back.  ``e2e``: the end-to-end metrics by
    name (value); ``record``: what the per-layer readers read (traced runs);
    ``checks``: (name, number, limit) of the comparison, each passing where
    number <= limit; ``correct`` is False also where the comparison could
    not be made (``problems``)."""
    attempted: int
    failed: int
    e2e: dict
    record: dict
    checks: list
    problems: list
    memory_peak_bytes: int
    window_s: float
    readings: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return not self.problems and all(
            v == v and v <= lim for _, v, lim in self.checks)


def metric_units(spec: dict) -> dict:
    return {m["name"]: m["unit"]
            for m in spec["end_to_end"] + spec["per_layer"]}


def cell_metrics(spec: dict, workload: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    this cell reports."""
    return [m for m in spec[section]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_values(ctx: Ctx, record: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell_metrics(ctx.spec, ctx.workload, "per_layer"):
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(record)
        if v is not None:
            out[m["name"]] = float(v)
    return out


def result_line(ctx: Ctx, out: Outcome, card: str, count: int) -> dict:
    """The JSON object of the run's last line."""
    units = metric_units(ctx.spec)
    if ctx.trace:
        values = per_layer_values(ctx, out.record)
    else:
        values = {m["name"]: out.e2e[m["name"]] for m in
                  cell_metrics(ctx.spec, ctx.workload, "end_to_end")}
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": card, "count": count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed),
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": device}
    if ctx.trace:
        trace = out.record.get("trace", {})
        device["busy_s"] = trace.get("busy_s", 0.0)
        device["window_s"] = trace.get("window_s", 0.0)
        if "breakdown" in trace:
            line["breakdown"] = trace["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in out.checks}
    if out.problems:
        line["checks"]["problems"] = "; ".join(out.problems)
    return line


def elapsed(t0: float) -> float:
    return time.perf_counter() - t0
