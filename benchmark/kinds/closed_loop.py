"""Traffic kind ``closed_loop``: a simulated fleet of B robots under the
flagship closed loop (``sim/engine``: penalty-ground physics, the 1 kHz
whole-body torque QP, an MPC update every ``mpc_every`` ticks, the gait
update in place of every ``gait_every``-th), replayed as
``engine.closed_loop`` replays it: one CUDA graph of an RTI period and one
of a gait period (``engine.period``), both captured in set-up, the state
chained through their carry.  Every ``restart_periods`` periods the fleet
restarts from fresh seeded starts.  Set it so that a window, at either
speed of a period, holds one whole episode and ends before the next
episode's first fall: the falls, and so ``failed``, are then those of one
whole episode, fixed by the seed, and not by how many periods the window
completed.

Traffic parameters: ``batch``, ``joint_perturbation`` (rad, the starts'
joints moved by it times N(0, 1)), ``restart_periods``, ``starts`` (how
many seeded sets of starts the restarts cycle through), ``check_periods``
(all of the window's where it is at least their number),
``check_scenarios`` (drawn anew for each sampled period) and
``check_ticks`` (what the comparison samples).
End-to-end: ``sim_s_per_s`` (B x ticks completed x control_dt over the
window's seconds) and ``setup_s``.  A scenario-period fails where its MPC
update is unsolved, a state is not finite, or the robot falls (its base
lower than 0.1 m under its start's, the flagship trot test's bound).
"""
from __future__ import annotations

import statistics
import time

import torch

from benchmark.harness import calls, compare, core, seeds, trace
from benchmark.reference import engine as ref_engine
from benchmark.reference import mpc_controller as ref_controller
from benchmark.reference import rbd as ref_rbd
from benchmark.reference import srb as ref_srb
from benchmark.reference import start as ref_start

FALL_M = 0.1
# a plan whose first node lies farther than this from the robot's state
# (the max-abs gap of the 13 SRB entries) does not start there: float32
# rounding leaves ~1e-7, a state one period old ~0.1
START_OFF = 1e-4
# a new plan within this of its input plan (relative, max-abs) has not
# moved: a rejected step leaves it there to float32 rounding (~1e-7), a
# taken one moves it by 1e-3 or more
UNMOVED = 1e-5
# what control.py's seeds share in one process (see ``run``)
KEPT: dict = {}


def program_configs(c: dict):
    from bilevel_gait_gen_tpu_torch.control.wbqp import WBQPConfig
    from bilevel_gait_gen_tpu_torch.sim.engine import SimConfig
    from benchmark.harness.a1mpc import program_config
    return (program_config(c["mpc"]), WBQPConfig(**c["wbqp"]),
            SimConfig(**c["sim"]))


def program_start(cfg, sim, stretch: float, dev):
    """The flagship's start on the program's side
    (``chip_smoke.loop_start``): the settled stand, the trot with every
    phase bound x ``stretch``, ``create_initial_run`` once.  Returns
    (model, params, state [1], q0 [nq], x_des [1, 12])."""
    from bilevel_gait_gen_tpu_torch.control import mpc_controller
    from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
    from bilevel_gait_gen_tpu_torch.mpc import gait, solver
    from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
    from bilevel_gait_gen_tpu_torch.sim import engine
    dtype = torch.float32
    model = a1.make_a1(device=dev)
    stand = torch.tensor(a1.stand_config(), dtype=dtype, device=dev)
    q0 = engine.settled_stand(model, sim, stand)
    params = srb.make_srb_params(model, q0)
    x0 = mpc_controller.reconstruct_srb_state(model, params, q0,
                                              torch.zeros_like(q0[1:]))
    feet0 = rbd.ee_positions(model, q0)
    sched = gait.GaitSchedule(bounds=gait.make_trot(
        cfg, dtype=dtype, device=dev).bounds * stretch)
    traj = default_trajectory(cfg, sched, x0[None], feet0[None, :, :2])
    st = solver.make_state(cfg, traj, torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=dev))
    x_des = srb.manifold_to_tangent(x0)[None]
    st, _ = solver.create_initial_run(cfg, params, st, x0[None], feet0[None],
                                      x_des)
    return model, params, st, q0, x_des


def starts(ctx, model, cfg, sim, st1, q0, x_des, B: int, dev):
    """The loop states of the seeded sets of starts: the planned stand's
    joints moved by ``joint_perturbation`` N(0, 1) a scenario."""
    from bilevel_gait_gen_tpu_torch.sim import engine
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    n = int(ctx.traffic["starts"])
    dq = seeds.joint_perturbations(n * B, model.num_joints, ctx.seed,
                                   ctx.traffic["joint_perturbation"])
    states = tree_map(lambda a: a.expand(B, *a.shape[1:]).clone(), st1)
    out = []
    for i in range(n):
        q = q0.expand(B, -1) + torch.cat([
            torch.zeros(B, 7, dtype=q0.dtype, device=dev),
            torch.tensor(dq[i * B:(i + 1) * B], device=dev).to(q0.dtype)],
            dim=-1)
        out.append(engine.initial_state(
            model, cfg, sim, states, q,
            torch.zeros(B, model.nv, dtype=q0.dtype, device=dev)))
    return out, dq


def run(ctx) -> core.Outcome:
    from bilevel_gait_gen_tpu_torch.sim import engine
    dev = ctx.device
    c = ctx.config
    cfg, wb, sim = program_configs(c)
    B = int(ctx.traffic["batch"])
    ticks = int(c["mpc_every"])
    dt = float(c["control_dt"])
    every = int(c["gait_every"])
    restart = int(ctx.traffic["restart_periods"])
    # the start and the graphs depend on no seed: control.py, which runs
    # many seeds in one process, makes them once
    key = (repr(sorted(c.items())), B, dev)
    kept = KEPT.get(key) if ctx.control else None
    if kept is None:
        model, params, st1, q0, x_des1 = program_start(cfg, sim,
                                                       c["stretch"], dev)
        x_des = x_des1.expand(B, -1).clone()
    else:
        model, params, st1, q0, x_des, graphs = kept
    lss, dq = starts(ctx, model, cfg, sim, st1, q0, x_des, B, dev)

    def period_fn(gait: bool):
        def fn(ls):
            return engine.period(model, params, cfg, wb, sim, x_des, ls,
                                 control_dt=dt, ticks=ticks, gait=gait,
                                 contact_sync=c["contact_sync"])
        return fn

    if kept is None:
        graphs = {g: core.loop(dev, period_fn(g), lss[0],
                               carry={0: lambda o: o[0]})
                  for g in (False, True)}
        if ctx.control:
            KEPT[key] = (model, params, st1, q0, x_des, graphs)
    fleet = Fleet(graphs, lss, x_des, every, restart, dev)
    fleet.period(keep=False)           # one warm replay of each graph
    fleet.period(keep=False, gait=True)
    fleet.restart()
    core.sync(dev)
    setup_s = core.elapsed(ctx.t_start)

    ends = []            # when each period's results reached the host
    t0 = time.perf_counter()
    while core.elapsed(t0) < ctx.seconds:
        fleet.period(keep=True)
        ends.append(core.elapsed(t0))
    window_s = core.elapsed(t0)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    n = len(fleet.log)
    failed = sum(r["failed"] for r in fleet.log)

    record = {}
    if ctx.trace:
        record = traced(ctx, model, params, cfg, wb, sim, fleet, dt)
    if not ctx.control:
        for g in graphs.values():
            g.close()
    if dev == "cuda":
        torch.cuda.empty_cache()

    readings, checks, problems = check(ctx, (model, params, st1, q0),
                                       fleet, dq, control=ctx.control)
    readings["period_ms"] = [1e3 * (b - a) for a, b in zip([0.0] + ends,
                                                           ends)]
    return core.Outcome(
        attempted=n * B, failed=failed,
        e2e={"sim_s_per_s": B * n * ticks * dt / window_s,
             "setup_s": setup_s},
        record=record, checks=checks, problems=problems,
        memory_peak_bytes=peak, window_s=window_s, readings=readings)


class Fleet:
    """The periods of the loop, the state chained from graph to graph and
    restarted every ``restart`` periods from the next set of starts; each
    kept period's input state and results kept for the comparison."""

    def __init__(self, graphs, starts_, x_des, every: int, restart: int,
                 dev: str):
        self.graphs, self.starts, self.every = graphs, starts_, every
        self.x_des = x_des
        self.restart_every, self.dev = restart, dev
        self.i = 0                # period within the episode
        self.episode = 0
        self.cur = starts_[0]
        self.log = []

    def restart(self) -> None:
        self.episode += 1
        self.i = 0
        self.cur = self.starts[self.episode % len(self.starts)]

    def period(self, keep: bool, gait: bool | None = None) -> None:
        from bilevel_gait_gen_tpu_torch.sim import engine
        if self.i == self.restart_every:
            self.restart()
        if gait is None:
            gait = engine.is_gait_period(self.i, self.every)
        g = self.graphs[gait]
        rec = {"gait": gait, "i": self.i, "episode": self.episode}
        if keep:
            rec["in"] = core.clone_tree(self.cur)
        ls, log = g(self.cur)
        z0 = self.starts[self.episode % len(self.starts)].q[:, 2]
        unsolved = ~log.solved[0]
        nonfinite = ~(torch.isfinite(log.q).flatten(2).all(-1).all(0)
                      & torch.isfinite(log.tau).flatten(2).all(-1).all(0))
        fell = log.q[..., 2].amin(0) < z0 - FALL_M
        counts = torch.stack([unsolved.sum(), nonfinite.sum(), fell.sum(),
                              (unsolved | nonfinite | fell).sum()]).tolist()
        rec["unsolved"], rec["nonfinite"], rec["fell"], rec["failed"] = counts
        self.cur = g.args[0]
        self.i += 1
        if keep:
            rec["out"] = core.clone_tree(ls)
            rec["log"] = core.clone_tree(log)
            self.log.append(rec)


def traced(ctx, model, params, cfg, wb, sim, fleet, dt) -> dict:
    """One RTI period under the profiler, one control tick replayed alone
    as a graph, and the ``bmv`` calls of one eager period with their
    roofline."""
    from bilevel_gait_gen_tpu_torch.models import rbd
    from bilevel_gait_gen_tpu_torch.sim import engine
    dev = ctx.device
    record = {"spans": {}}
    ls = core.clone_tree(fleet.cur)
    B = ls.q.shape[0]
    t = ((ls.tick + 1).to(ls.q.dtype) * dt).expand(B).contiguous()
    t0 = ls.t0.clone()

    def tick(q, v, mc):
        return engine.control_tick(model, params, cfg, wb, sim, ls.st, q, v,
                                   t, t0, mc, control_dt=dt)

    mc = engine.latch_contact(sim, rbd.ee_positions(model, ls.q), ls.mc)
    gt = core.loop(dev, tick, ls.q, ls.v, mc)
    record["spans"]["tick_ms"] = trace.span_ms(gt, 10, dev)
    if dev == "cuda":
        # one tick, not a whole period: a period's 400,000 operations
        # overflow the profiler's buffers, whose flushes open gaps that a
        # run without the profiler does not have
        record["trace"] = trace.profile(gt)
    gt.close()
    if dev == "cuda":
        rec = calls.record(lambda: engine.period(
            model, params, cfg, wb, sim, fleet.x_des, ls, control_dt=dt,
            ticks=int(ctx.config["mpc_every"]), gait=False,
            contact_sync=ctx.config["contact_sync"]), kinds=("bmv",))
        record["roofline"] = {"bmv": calls.roofline(rec, ("bmv",))}
    return record


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def start_gaps(prog_ls, ref) -> dict:
    """The program's first set of starts against the reference's: the
    settled, perturbed stands (``start_q_rel``) and the initial run's plan
    (``start_plan_rel``, its states, forces, footholds and contact
    times)."""
    _, _, states, q0s, _, _, _ = ref
    st = prog_ls.st
    parts = [(st.traj.x_man, states.traj.x_man),
             (st.traj.f_nodes, states.traj.f_nodes),
             (st.traj.footholds, states.traj.footholds),
             (st.traj.sched.bounds, states.traj.sched.bounds)]
    return {"start_q_rel": compare.rel_gap(prog_ls.q, q0s),
            "start_plan_rel": max(compare.rel_gap(a, b) for a, b in parts)}


def program_time(tick: torch.Tensor, j: int, dt: float) -> torch.Tensor:
    """[1] the time of tick ``j`` of a period as the program computes it
    (``engine.period``: the tick in float32 times control_dt, in float32),
    so that the reference meets every phase bound on the side the program
    met it."""
    return ((tick + j).to(torch.float32) * dt).reshape(1)


def _as_loop_state(ref):
    """A reference start as the fields ``start_gaps`` reads."""
    _, _, states, q0s, _, _, _ = ref

    class Start:
        q, st = q0s, states
    return Start


def gather(fleet, picks_p, picks_b, picks_j):
    """The sampled periods' inputs and answers, one row a (period,
    scenario) pair (``picks_b[n]``: the scenarios of the ``n``-th sampled
    period), and for each pair its ticks' inputs and answers."""
    pairs = [(p, b) for p, bs in zip(picks_p, picks_b) for b in bs]
    bi = lambda b: torch.tensor([b])  # noqa: E731
    ins = [compare.rows(fleet.log[p]["in"], bi(b)) for p, b in pairs]
    outs = [compare.rows(fleet.log[p]["out"], bi(b)) for p, b in pairs]
    logs = [compare.rows(fleet.log[p]["log"], bi(b), dim=1)
            for p, b in pairs]
    return pairs, ins, outs, logs


def run_reference(rcfg, rwb, rsim, ref, pairs, ins, outs, logs, fleet,
                  picks_j, dt, dtype, dev, contact_sync):
    """The reference's MPC updates from the sampled periods' input states,
    and its control ticks from the program's plans and states."""
    rmodel, rparams, _, _, _, rx_des, _ = ref
    if dtype != torch.float64:
        rparams = compare.to_ref(rparams, dtype, dev)
    res = {}
    # the MPC updates, one call for the RTI periods and one for the gait's
    for gait in (False, True):
        idx = [k for k, (p, _) in enumerate(pairs)
               if fleet.log[p]["gait"] == gait]
        if not idx:
            continue
        ls = compare.to_ref(compare.stack([ins[k] for k in idx]), dtype, dev)
        q, v = ls.q, ls.v
        t = torch.cat([program_time(fleet.log[pairs[k][0]]["in"].tick, 0,
                                    dt) for k in idx]).to(dev, dtype)
        feet = ref_rbd.ee_positions(rmodel, q)
        mc = ref_engine.latch_contact(rsim, feet, ls.mc)
        loop_state = ref_engine.LoopState(
            q=q, v=v, st=ls.st, t0=ls.t0, mc=mc, trust=ls.trust,
            tick=torch.zeros((), dtype=torch.int64, device=dev))
        st, stats, trust = ref_engine.mpc_update(
            rmodel, rparams, rcfg, loop_state, t, rx_des[:len(idx)].to(dtype),
            feet, mc, gait=gait, contact_sync=contact_sync)
        res[gait] = {"idx": idx, "cost": stats.cost, "solved": stats.solved,
                     "x_man": st.traj.x_man, "bounds": st.traj.sched.bounds,
                     "x_in": ls.st.traj.x_man,
                     "x0": ref_controller.reconstruct_srb_state(
                         rmodel, rparams, q, v)}
    # the control ticks from the program's plans
    rows = [(k, j) for k in range(len(pairs)) for j in picks_j]
    inp = compare.to_ref(compare.stack(ins), dtype, dev)
    q_seq = [compare.to_ref(torch.cat([ins[k].q[None], logs[k].q]), dtype,
                            dev) for k in range(len(pairs))]
    v_seq = [compare.to_ref(torch.cat([ins[k].v[None], logs[k].v]), dtype,
                            dev) for k in range(len(pairs))]
    # the contact latch along the program's states, from each period's
    # own, all pairs at once
    jmax = max(picks_j)
    q_all = torch.cat([s[:jmax + 1] for s in q_seq], dim=1)
    mc = inp.mc
    mc_j = []
    for j in range(jmax + 1):
        mc = ref_engine.latch_contact(
            rsim, ref_rbd.ee_positions(rmodel, q_all[j]), mc)
        mc_j.append(mc)
    mcs = [[m[k:k + 1] for m in mc_j] for k in range(len(pairs))]
    st = compare.to_ref(compare.stack([outs[k].st for k, _ in rows]), dtype,
                        dev)
    q = torch.cat([q_seq[k][j] for k, j in rows])
    v = torch.cat([v_seq[k][j] for k, j in rows])
    mc = torch.cat([mcs[k][j] for k, j in rows])
    t = torch.cat([program_time(fleet.log[pairs[k][0]]["in"].tick, j, dt)
                   for k, j in rows]).to(dev, dtype)
    t0 = torch.cat([compare.to_ref(outs[k].t0, dtype, dev) for k, _ in rows])
    q1, v1, tau = ref_engine.control_tick(
        rmodel, rparams, rcfg, rwb, rsim, st, q, v, t, t0, mc,
        control_dt=dt)
    # the physics alone, from the program's own torques
    tau_p = compare.to_ref(torch.cat([logs[k].tau[j] for k, j in rows]),
                           dtype, dev)
    qp, vp = q, v
    for _ in range(rsim.substeps):
        qp, vp = ref_engine.physics_step(rmodel, rsim, qp, vp, tau_p,
                                         dt / rsim.substeps)
    res["ticks"] = {"rows": rows, "q": q1, "v": v1, "tau": tau,
                    "phys_q": qp, "phys_v": vp}
    return res


def program_answers(pairs, ins, outs, logs, fleet, picks_j) -> dict:
    """The program's sampled MPC updates and control ticks, in the form of
    :func:`run_reference`'s result."""
    res = {}
    for gait in (False, True):
        idx = [k for k, (p, _) in enumerate(pairs)
               if fleet.log[p]["gait"] == gait]
        if idx:
            res[gait] = {
                "idx": idx,
                "cost": torch.cat([logs[k].cost[0] for k in idx]),
                "solved": torch.cat([logs[k].solved[0] for k in idx]),
                "x_man": torch.cat([outs[k].st.traj.x_man for k in idx]),
                "bounds": torch.cat([outs[k].st.traj.sched.bounds
                                     for k in idx]),
                "x_in": torch.cat([ins[k].st.traj.x_man for k in idx])}
    rows = [(k, j) for k in range(len(pairs)) for j in picks_j]
    res["ticks"] = {"rows": rows, **{
        f: torch.cat([getattr(logs[k], f)[j] for k, j in rows])
        for f in ("q", "v", "tau")}}
    res["ticks"]["phys_q"] = res["ticks"]["q"]
    res["ticks"]["phys_v"] = res["ticks"]["v"]
    return res


def off_step(out0: torch.Tensor, in0: torch.Tensor,
             x0: torch.Tensor) -> float:
    """How far a new plan's first node lies from where a step of any
    length leaves it: the RTI moves the node, in the tangent space, from
    the input plan's first node toward the robot's state by the share the
    line search takes (0 where it rejects the step or the gate fails, 1
    for a full step).  The max-abs distance of ``out0`` from that segment
    (inf where a node is not finite)."""
    a, b, c = (ref_srb.manifold_to_tangent(z.detach().double().cpu())
               for z in (in0, x0, out0))
    if not all(bool(torch.isfinite(z).all()) for z in (a, b, c)):
        return float("inf")
    d = b - a
    share = float(torch.clamp(torch.dot(c - a, d)
                              / torch.clamp_min(torch.dot(d, d), 1e-30),
                              0.0, 1.0))
    return float(torch.amax(torch.abs(c - a - share * d)))


def numbers(a: dict, r: dict) -> dict:
    """The sampled MPC updates and control ticks of ``a`` (the program's,
    or the control's) against the float64 reference's ``r``, each on its
    own (``each_mpc``, ``each_tick``): an update's solved flag, cost, plan
    and contact times; a tick's torques (N m) and next state; and over the
    sample the flags that differ, and the median, upper quartile and worst
    of each gap."""
    each = {"flags": [], "cost_rel": [], "plan_rel": [], "bounds_s": [],
            "moved": [], "ref_moved": [], "plan_start": [],
            "plan_off_step": []}
    for gait in (False, True):
        if gait not in r:
            continue
        x, y = a[gait], r[gait]
        for n in range(len(y["idx"])):
            one = slice(n, n + 1)
            each["flags"].append(compare.count_diff(x["solved"][one],
                                                    y["solved"][one]))
            each["cost_rel"].append(compare.rel_gap(x["cost"][one],
                                                    y["cost"][one]))
            each["plan_rel"].append(compare.rel_gap(x["x_man"][one],
                                                    y["x_man"][one]))
            each["bounds_s"].append(compare.abs_gap(x["bounds"][one],
                                                    y["bounds"][one]))
            # how far each side's new plan lies from the update's input
            each["moved"].append(compare.rel_gap(x["x_man"][one],
                                                 y["x_in"][one]))
            each["ref_moved"].append(compare.rel_gap(y["x_man"][one],
                                                     y["x_in"][one]))
            # where the new plan starts, against the robot's SRB state at
            # the update, which the plan claims to start from
            each["plan_start"].append(compare.abs_gap(
                x["x_man"][one][:, 0], y["x0"][one]))
            each["plan_off_step"].append(off_step(
                x["x_man"][n, 0], y["x_in"][n, 0], y["x0"][n]))
    ticks = {"tau_nm": [], "q": [], "v": [], "phys_q": [], "phys_v": []}
    for n in range(len(r["ticks"]["rows"])):
        one = slice(n, n + 1)
        for name, f in (("tau_nm", "tau"), ("q", "q"), ("v", "v"),
                        ("phys_q", "phys_q"), ("phys_v", "phys_v")):
            ticks[name].append(compare.abs_gap(a["ticks"][f][one],
                                               r["ticks"][f][one]))
    n = len(each["moved"])
    out = {"mpc_solved_differ": float(sum(each["flags"])),
           # updates whose new plan does not start at the robot's state
           "mpc_start_off_share": sum(x > START_OFF for x in
                                      each["plan_start"]) / n,
           # updates whose new plan is the input plan: a step rejected by
           # the line search or the gate, or a state handed back unchanged
           "mpc_unmoved_share": sum(x < UNMOVED for x in each["moved"]) / n}
    for pre, group in (("mpc_", each), ("tick_", ticks)):
        for name, v in group.items():
            if name == "flags":
                continue
            out.update({f"{pre}{name}_median": statistics.median(v),
                        f"{pre}{name}_q75": compare.q75(v),
                        f"{pre}{name}_max": max(v)})
    out["each_mpc"], out["each_tick"] = each, ticks
    return out


def check(ctx, prog_start, fleet, dq, control: bool = False):
    """The start, and the sampled periods' MPC updates and control ticks
    (drawn from the seed), each run again by the reference from the
    program's own states.  Returns (readings, checks, problems)."""
    dev = ctx.device
    c = ctx.config
    B = fleet.starts[0].q.shape[0]
    dt, ticks = float(c["control_dt"]), int(c["mpc_every"])
    rcfg = compare.ref_mpc_config(c["mpc"])
    rwb, rsim = compare.ref_wb_config(c["wbqp"]), compare.ref_sim_config(
        c["sim"])
    n = int(ctx.traffic["check_scenarios"])
    picks_p = seeds.sample(ctx.seed, len(fleet.log),
                           int(ctx.traffic["check_periods"])).tolist()
    # each period's own scenarios, so that the sample spreads over robots
    # as it does over periods
    picks_b = [seeds.sample(ctx.seed, B, n, salt=3 + p).tolist()
               for p in picks_p]
    picks_j = seeds.sample(ctx.seed, ticks, int(ctx.traffic["check_ticks"]),
                           salt=2).tolist()
    ref64 = ref_start.loop_start(rcfg, rsim, c["stretch"], dq[:B], device=dev)
    readings = {"program": start_gaps(fleet.starts[0], ref64)}
    pairs, ins, outs, logs = gather(fleet, picks_p, picks_b, picks_j)
    sub = torch.tensor([b for _, b in pairs])
    ref64s = ref64[:5] + (compare.rows(ref64[5], sub), ref64[6])

    def ref_run(dtype, tf32=False):
        with compare.precision(tf32):
            return run_reference(rcfg, rwb, rsim, ref64s, pairs, ins, outs,
                                 logs, fleet, picks_j, dt, dtype, dev,
                                 c["contact_sync"])

    r64 = ref_run(torch.float64)
    prog = program_answers(pairs, ins, outs, logs, fleet, picks_j)
    readings["program"].update(numbers(prog, r64))
    readings["failed_by_cause"] = {
        k: sum(r[k] for r in fleet.log)
        for k in ("unsolved", "nonfinite", "fell")}
    readings["sample"] = {"periods_in_window": len(fleet.log),
                          "periods": picks_p, "scenarios": picks_b,
                          "ticks": picks_j}
    if control:
        for name, tf32 in (("control_tf32", True), ("plain_float32", False)):
            with compare.precision(tf32):
                ref32 = ref_start.loop_start(rcfg, rsim, c["stretch"], dq[:B],
                                             device=dev, dtype=torch.float32)
            r32 = ref_run(torch.float32, tf32)
            readings[name] = {**start_gaps(_as_loop_state(ref32), ref64),
                              **numbers(r32, r64)}
        # a second witness: the program against the plain float32 reference
        readings["program_vs_float32"] = numbers(prog, r32)
    return (readings,) + compare.judged(readings["program"],
                                        ctx.limits["numbers"])
