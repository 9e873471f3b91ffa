"""Traffic kind ``cadence``: a fleet of B scenarios on ``bench.py``'s
cadence, one ``mpc/cadence.cycle`` after another (``gait_every - 1``
real-time iterations (RTIs), then the gait update in place of the next),
the cycle captured once as a CUDA graph and replayed back to back; the
host reads each cycle's solved flags.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``perturbation``
(the measured states' spread, 0.02 N(0, 1) in ``bench.py``) and
``check_answers`` (how many scenario-cycles the comparison samples).
End-to-end: ``solves_per_s``, every scenario-update delivered in the
window over the window's seconds (a cycle delivers B ``gait_every``), and
``setup_s``.  A scenario-update fails where the solver's gate marks it
unsolved or its answer is not finite.
"""
from __future__ import annotations

import statistics
import time

import torch

from benchmark.harness import a1mpc, calls, compare, core, seeds, trace
from benchmark.reference import bilevel as ref_bilevel
from benchmark.reference import solver as ref_solver


def kept(out) -> dict:
    """What the comparison reads of a cycle's results, batch first."""
    _, solved, gres, _ = out
    return {"solved": solved.T, "rti_solved": gres.rti_stats.solved,
            "rti_cost": gres.rti_stats.cost, "rti_obj": gres.rti_obj,
            "x_man": gres.state.traj.x_man,
            "bounds": gres.state.traj.sched.bounds, "trust": gres.trust,
            "accepted": gres.accepted, "gait_cost": gres.cost}


def failures(k: dict) -> torch.Tensor:
    """Scenario-updates of a cycle that failed: RTIs the gate marked
    unsolved, and gait updates whose embedded RTI was unsolved or whose new
    contact times or trust radius are not finite."""
    gait_bad = (~k["rti_solved"] | ~torch.isfinite(k["bounds"]).flatten(1)
                .all(-1) | ~torch.isfinite(k["trust"]))
    return (~k["solved"]).sum() + gait_bad.sum()


def ref_cycle(rcfg, params, st, x0s, t0, feets, x_des, freq: int) -> dict:
    """The reference's cycle from the states ``st``."""
    solved = []
    for _ in range(freq - 1):
        st, stats = ref_solver.solve_step(rcfg, params, st, x0s, t0, feets,
                                          x_des)
        solved.append(stats.solved)
    g = ref_bilevel.gait_opt_update(rcfg, params, st, x0s, t0, feets, x_des)
    return {"solved": torch.stack(solved, dim=1),
            "rti_solved": g.rti_stats.solved, "rti_cost": g.rti_stats.cost,
            "rti_obj": g.rti_obj, "x_man": g.state.traj.x_man,
            "bounds": g.state.traj.sched.bounds, "trust": g.trust,
            "accepted": g.accepted, "gait_cost": g.cost, "x0": x0s}


def each_rel(c: torch.Tensor, r: torch.Tensor) -> list[float]:
    """The relative gap of each sampled answer (rows of c and r)."""
    return [compare.rel_gap(c[i:i + 1], r[i:i + 1]) for i in range(len(c))]


def each_abs(c: torch.Tensor, r: torch.Tensor) -> list[float]:
    return [compare.abs_gap(c[i:i + 1], r[i:i + 1]) for i in range(len(c))]


def numbers(c: dict, r: dict) -> dict:
    """A cycle's answers ``c`` against the reference's ``r``, each sampled
    scenario-cycle on its own (``each``): the solved flags that differ (its
    nine RTIs and the gait update's embedded one), the embedded RTI's cost,
    the new plan and contact times, the gait update's objective, trust
    radius and accept; and over the sample the flags that differ, the share
    unsolved, and the median, upper quartile and worst of each gap."""
    flags_each = ((c["solved"].cpu() != r["solved"].cpu()).sum(-1)
                  + (c["rti_solved"].cpu() != r["rti_solved"].cpu())
                  ).double().tolist()
    each = {"flags": flags_each,
            "rti_cost_rel": each_rel(c["rti_cost"], r["rti_cost"]),
            "plan_rel": each_rel(c["x_man"], r["x_man"]),
            "bounds_s": each_abs(c["bounds"], r["bounds"]),
            "gait_cost_rel": each_rel(c["gait_cost"], r["gait_cost"]),
            "trust_rel": each_rel(c["trust"], r["trust"]),
            "accepted": (c["accepted"].cpu() != r["accepted"].cpu()
                         ).double().tolist(),
            # where the new plan starts, against the scenario's measured
            # state, which the plan claims to start from
            "plan_start": each_abs(c["x_man"][:, 0], r["x0"])}
    flags = torch.cat([c["solved"].flatten(), c["rti_solved"].flatten()])
    out = {"solved_flags_differ": float(sum(flags_each)),
           "unsolved_share": float((~flags.cpu()).float().mean()),
           "accepted_differ": float(sum(each["accepted"]))}
    for name in ("rti_cost_rel", "plan_rel", "bounds_s", "gait_cost_rel",
                 "trust_rel", "plan_start"):
        v = each[name]
        out.update({f"{name}_median": statistics.median(v),
                    f"{name}_q75": compare.q75(v), f"{name}_max": max(v)})
    out["each"] = each
    return out


def run(ctx) -> core.Outcome:
    from bilevel_gait_gen_tpu_torch.mpc import bilevel, cadence
    dev = ctx.device
    cfg = a1mpc.program_config(ctx.config["mpc"])
    freq = int(ctx.config["gait_every"])
    B = int(ctx.traffic["batch"])
    pert = a1mpc.perturbations(ctx, B)
    pr = a1mpc.program_problem(cfg, B, pert, dev)
    rest = (pr.x0s, pr.t0, pr.feets, pr.x_des)

    def cyc(st, x, t, f, xd):
        return cadence.cycle(cfg, pr.params, st, x, t, f, xd, freq)

    g = core.loop(dev, cyc, pr.states, *rest, carry={0: lambda o: o[0]})
    g()
    core.sync(dev)
    setup_s = core.elapsed(ctx.t_start)

    # the window
    ins, outs = [], []
    attempted = failed = 0
    ends = []            # when each cycle's flags reached the host
    t0 = time.perf_counter()
    while True:
        ins.append(core.clone_tree(g.args[0]))
        k = core.clone_tree(kept(g()))
        failed += int(failures(k))
        attempted += B * freq
        outs.append(k)
        ends.append(core.elapsed(t0))
        if ends[-1] >= ctx.seconds:
            break
    window_s = core.elapsed(t0)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    record = {}
    if ctx.trace:
        record = traced(ctx, cfg, pr, g, cyc, rest, freq, bilevel, cadence)
    g.close()
    del g
    if dev == "cuda":
        torch.cuda.empty_cache()

    readings, checks, problems = check(ctx, cfg, pr, pert, ins, outs, freq,
                                       control=ctx.control)
    readings["cycle_ms"] = [1e3 * (b - a) for a, b in zip([0.0] + ends,
                                                          ends)]
    return core.Outcome(
        attempted=attempted, failed=failed,
        e2e={"solves_per_s": attempted / window_s, "setup_s": setup_s},
        record=record, checks=checks, problems=problems,
        memory_peak_bytes=peak, window_s=window_s, readings=readings)


def traced(ctx, cfg, pr, g, cyc, rest, freq, bilevel, cadence) -> dict:
    """The per-layer record: one cycle under the profiler, the RTI block
    and the gait update each replayed alone as a graph, and the kernel
    calls of one eager cycle with their roofline."""
    dev = ctx.device
    record = {"spans": {}}
    if dev == "cuda":
        record["trace"] = trace.profile(g)
    st = core.clone_tree(g.args[0])
    blk = core.loop(dev, lambda s, x, t, f, xd: cadence.rti_block(
        cfg, pr.params, s, x, t, f, xd, freq - 1), st, *rest)
    record["spans"]["rti_ms"] = [
        ms / (freq - 1) for ms in trace.span_ms(blk, 5, dev)]
    blk.close()
    gup = core.loop(dev, lambda s, x, t, f, xd: bilevel.gait_opt_update(
        cfg, pr.params, s, x, t, f, xd), st, *rest)
    record["spans"]["gait_update_ms"] = trace.span_ms(gup, 5, dev)
    gup.close()
    if dev == "cuda":
        rec = calls.record(lambda: cyc(core.clone_tree(st), *rest),
                           kinds=("gtwg", "ipm_iter"))
        record["roofline"] = {"sweep": calls.roofline(rec,
                                                      ("gtwg", "ipm_iter"))}
    return record


def check(ctx, cfg, pr, pert, ins, outs, freq: int, control: bool = False):
    """The start, and a sample of the window's scenario-cycles (drawn from
    the seed) run again by the reference from the program's input states.
    Returns (readings, checks, problems)."""
    dev = ctx.device
    B = pr.x0s.shape[0]
    K = int(ctx.traffic["check_answers"])
    picks = seeds.sample(ctx.seed, len(outs) * B, K)
    rcfg = compare.ref_mpc_config(ctx.config["mpc"])
    rp = a1mpc.reference_problem(rcfg, pert, dev)
    readings = {"program": {"start_rel": a1mpc.start_gap(pr, rp)}}
    cycles, scen = picks // B, picks % B
    c_in = compare.stack([compare.rows(ins[c], torch.tensor([b]))
                          for c, b in zip(cycles, scen)])
    c_out = compare.stack([compare.rows(outs[c], torch.tensor([b]))
                           for c, b in zip(cycles, scen)])
    idx = torch.tensor(scen)

    def ref_run(dtype, tf32=False):
        params = rp.params if dtype == torch.float64 else \
            compare.to_ref(rp.params, dtype, dev)
        args = [compare.rows(a, idx).to(dtype)
                for a in (rp.x0s, rp.t0, rp.feets, rp.x_des)]
        with compare.precision(tf32):
            return ref_cycle(rcfg, params, compare.to_ref(c_in, dtype, dev),
                             *args, freq)

    ref = ref_run(torch.float64)
    readings["program"].update(numbers(c_out, ref))
    readings["sample"] = {"cycles_in_window": len(outs),
                          "cycles": cycles.tolist(), "scenarios": scen.tolist()}
    if control:
        for name, tf32 in (("control_tf32", True), ("plain_float32", False)):
            with compare.precision(tf32):
                rp32 = a1mpc.reference_problem(rcfg, pert, dev, torch.float32)
            r32 = ref_run(torch.float32, tf32)
            readings[name] = {"start_rel": a1mpc.start_gap(rp32, rp),
                              **numbers(r32, ref)}
        # a second witness: the program against the plain float32 reference
        readings["program_vs_float32"] = numbers(c_out, r32)
    return finish(ctx, readings)


def finish(ctx, readings):
    return (readings,) + compare.judged(readings["program"],
                                        ctx.limits["numbers"])
