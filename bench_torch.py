#!/usr/bin/env python3
"""Headline benchmark of bilevel_gait_gen_tpu_torch on one NVIDIA GPU:
batched bilevel-MPC solves per second (the port of ``bench.py``).

    python3 bench_torch.py                 # from the root of a checkout
    python3 bench_torch.py --profile       # and a profile of one cycle
    python3 bench_torch.py --device cpu --cycles 1 --single-reps 2 \\
        --chain-reps 1 --chain-k 2 --gait-k 1      # control flow only

Prints ONE JSON line.  Its keys are those of bench.py with the same
meanings, and what a GPU adds.  The timed cadence is bench.py's: B
scenarios, ``FREQ - 1`` real-time iterations (RTIs), then the full gait
update in place of the ``FREQ``-th (the embedded RTI, the IFT gradient, the
projection QP, the line-search lanes); ``value`` counts B * FREQ delivered
solves a cycle.  bench.py runs each of its loops as one jitted dispatch.
Here each loop (``mpc/cadence.py``) is captured once as a CUDA graph
(``utils/graphs.Graphed``) and replayed, and the cadence and the RTI block
also run eagerly in the same run (``eager_*``), so that graph and eager are
compared on one card.

Every section times ``--cycles`` (10 unless told) synchronized calls on
the host clock after one untimed call.  Each rate and each time per solve,
per cycle or per update is, as in bench.py, all the work over the summed
time of all timed calls; the calls' spread (mean, median, p10, p90, min,
max) stands beside it under ``*_ms``.  The single-solve latencies are
percentiles of ``--single-reps`` (300) calls and the chained solve's tail of
``--chain-reps`` (60).  Before it times anything, the script holds each
hand-written kernel to its plain version at every shape it is about to run,
on inputs that the plain version moves by more than the tolerance.
It needs a CUDA device unless ``--device cpu`` is given; on the CPU nothing
is graphed, the kernel wrappers run their plain versions and the kernel
checks are skipped, so a CPU run checks the bench's control flow and no
device number.  Any failed check raises: the script then exits non-zero
and prints no result.

Environment, as bench.py reads it: BENCH_BATCH (128), BENCH_GAIT_OPT_FREQ
(10), BENCH_IPM_ITERS (10), BENCH_EXACT_EVERY (5), BENCH_GRAD_POLISH (2),
BENCH_QP_KERNEL ("xla"), BENCH_LS_ITERS, BENCH_LS_EXACT, BENCH_LS_ALPHAS
(the configuration's defaults), BENCH_AB (1: the gait-opt A/B grid),
BENCH_AB_CYCLES (5), BENCH_N50 (1: the N=50 block at batch 32).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
AB_STRETCHES = (0.7, 0.8, 0.9, 1.1, 1.2, 1.35, 1.5, 1.6)
AB_SETTLE = 5
N50_BATCH = 32
N50_BLOCK = 10
RT_BUDGET_MS = 50.0
SOLVED_MIN = 0.95


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def bench_config():
    """bench.py's MPCConfig: N=20, dt=0.05, with its environment."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(
        ipm_iters=env_int("BENCH_IPM_ITERS", 10),
        ipm_exact_every=env_int("BENCH_EXACT_EVERY", 5),
        ipm_grad_polish=env_int("BENCH_GRAD_POLISH", 2),
        qp_kernel=os.environ.get("BENCH_QP_KERNEL", "xla"),
        ls_ipm_iters=env_int("BENCH_LS_ITERS", 0) or MPCConfig.ls_ipm_iters,
        ls_exact_every=(env_int("BENCH_LS_EXACT", 0)
                        or MPCConfig.ls_exact_every),
        ls_alphas=env_int("BENCH_LS_ALPHAS", 0) or MPCConfig.ls_alphas,
    ).validate()


def n50_config(cfg):
    """bench.py's N=50, dt=0.02 configuration (the reference's hardware
    and gait-opt problem size), with the N=20 run's sweep counts."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
    return MPCConfig(num_nodes=50, dt=0.02, ipm_iters=cfg.ipm_iters,
                     ipm_exact_every=cfg.ipm_exact_every).validate()


def spread(ms: list[float]) -> dict:
    a = np.asarray(ms, dtype=np.float64)
    return {"mean": float(a.mean()), "median": float(np.median(a)),
            "p10": float(np.percentile(a, 10)),
            "p90": float(np.percentile(a, 90)),
            "min": float(a.min()), "max": float(a.max()), "n": len(ms)}


class Eager:
    """The interface of ``Graphed``, run op by op: the eager column, and
    every loop on the CPU."""

    def __init__(self, fn, *args, carry=None):
        self.fn, self.args = fn, list(args)
        self.carry = dict(carry or {})
        self.out = None

    def __call__(self, *args):
        if args:
            self.args = list(args)
        self.out = self.fn(*self.args)
        for i, pick in self.carry.items():
            self.args[i] = pick(self.out)
        return self.out

    def close(self) -> None:
        self.out = self.args = None


class Bench:
    """The device, how a loop is run on it, and the clock."""

    def __init__(self, device: str):
        import torch
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"

    def sync(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def loop(self, fn, *args, carry=None, graphed: bool = True):
        """``fn`` over ``args`` as a CUDA graph on the card (``graphed``),
        else eagerly."""
        from bilevel_gait_gen_tpu_torch.utils.graphs import Graphed
        if graphed and self.cuda:
            return Graphed(fn, *args, carry=carry)
        return Eager(fn, *args, carry=carry)

    def times_ms(self, call, reps: int, after=None) -> list[float]:
        """Milliseconds of ``reps`` synchronized calls after one untimed
        call; ``after()`` runs after each timed call, outside the window."""
        call()
        self.sync()
        out = []
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            call()
            self.sync()
            out.append((time.perf_counter() - t0) * 1e3)
            if after is not None:
                after()
        return out


def state_of(out):
    return out[0]


# ---------------------------------------------------------------------------
# the kernels at the shapes of the run
# ---------------------------------------------------------------------------

def check_kernels_at(cfg, batch: int, label: str) -> list[dict]:
    """One RTI, then one gait update, at this configuration and batch, with
    the kernel calls recorded; each recorded call is held to the kernel's
    plain version and timed (``kernel_checks.check_recorded_calls``).
    Returns one row per kernel and shape."""
    from bilevel_gait_gen_tpu_torch.mpc import bilevel, solver
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg, batch, device="cuda")
    st, _ = solver.solve_step(cfg, pr.params, *pr.loop_args())
    calls = kc.record_kernel_calls(lambda: bilevel.gait_opt_update(
        cfg, pr.params, st, *pr.loop_args()[1:]))
    return kc.check_recorded_calls(calls, label)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def cadence_n20(bench: Bench, cfg, batch: int, freq: int, cycles: int,
                profile: bool) -> dict:
    """bench.py's cadence and rti_block at batch ``batch``, graphed and
    eager, with the launches the graphed cycle captured.  The solved
    fraction, accept rate and mean step are means over the timed graphed
    cycles."""
    from bilevel_gait_gen_tpu_torch.mpc import cadence
    from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg, batch, device=bench.dev)

    def cyc(st, x, t, f, xd):
        return cadence.cycle(cfg, pr.params, st, x, t, f, xd, freq)

    def blk(st, x, t, f, xd):
        return cadence.rti_block(cfg, pr.params, st, x, t, f, xd, freq)

    out = {}
    rest = pr.loop_args()[1:]
    # graphed first, from the problem as made (bench.py's order: the
    # cadence, then the RTI block from the state it leaves); then the same
    # functions eagerly from where the graphs ended
    g = bench.loop(cyc, *pr.loop_args(), carry={0: state_of})
    fracs, accepts, alphas, all_solved = [], [], [], []

    def read():
        _, solved, gres, frac = g.out
        fracs.append(float(frac))
        accepts.append(float(gres.accepted.float().mean()))
        alphas.append(float(gres.alpha.mean()))
        all_solved.append(bool(solved.all())
                          and bool(gres.rti_stats.solved.all()))

    cyc_ms = bench.times_ms(g, cycles, after=read)
    launches = getattr(g, "captured_launches", None)
    if profile:
        out["profile_graphed_cycle"] = kc.profile_call(g, "graphed cycle")
    gb = bench.loop(blk, g.args[0], *rest, carry={0: state_of})
    blk_ms = bench.times_ms(gb, cycles)
    st = gb.args[0]
    for lp in (g, gb):
        lp.close()

    loop = bench.loop(cyc, st, *rest, carry={0: state_of}, graphed=False)
    eager_cyc = bench.times_ms(loop, cycles)
    loop = bench.loop(blk, loop.args[0], *rest, carry={0: state_of},
                      graphed=False)
    eager_blk = bench.times_ms(loop, cycles)
    if profile:
        out["profile_eager_cycle"] = kc.profile_call(
            Eager(cyc, loop.args[0], *rest), "eager cycle")

    # all the work over the summed time of the timed calls
    c, b = np.mean(cyc_ms), np.mean(blk_ms)
    ce, be = np.mean(eager_cyc), np.mean(eager_blk)
    out.update({
        "value": batch * freq / (c / 1e3),
        "inner_rti_solves_per_s": batch * freq / (b / 1e3),
        "gait_opt_update_ms": c - b * (freq - 1) / freq,
        "batch_latency_ms": b / freq,
        "all_solved": all(all_solved),
        "solved_frac": float(np.mean(fracs)),
        "solved_frac_min": float(np.min(fracs)),
        "gait_opt_alpha_mean": float(np.mean(alphas)),
        "gait_opt_accept_rate": float(np.mean(accepts)),
        "eager_value": batch * freq / (ce / 1e3),
        "eager_batch_latency_ms": be / freq,
        "eager_gait_opt_update_ms": ce - be * (freq - 1) / freq,
        "cadence_ms": spread(cyc_ms),
        "eager_cadence_ms": spread(eager_cyc),
        "rti_block_ms": spread(blk_ms),
        "eager_rti_block_ms": spread(eager_blk),
        "cycle_captured_launches": launches,
    })
    return out


def single_robot(bench: Bench, cfg, reps: int, chain_reps: int, chain_k: int,
                 gait_k: int, cycles: int) -> dict:
    """Batch 1: the single-solve latency, the chained RTIs and the chained
    gait updates with the trust radius carried (bench.py:165-238), from the
    standing state as bench.py's ``state``, ``x0`` and ``feet0``: the
    measured state is the unperturbed one."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import cadence
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg, 1, device=bench.dev)
    rest = (pr.states.traj.x_man[:, 0].contiguous(), pr.t0, pr.feets,
            pr.x_des)

    def step(st, x, t, f, xd):
        return cadence.rti_block(cfg, pr.params, st, x, t, f, xd, 1)

    def chain(st, x, t, f, xd):
        return cadence.rti_block(cfg, pr.params, st, x, t, f, xd, chain_k)

    def gchain(st, tr, x, t, f, xd):
        return cadence.gait_chain(cfg, pr.params, st, tr, x, t, f, xd,
                                  gait_k)

    g = bench.loop(step, pr.states, *rest, carry={0: state_of})
    lats = bench.times_ms(g, reps)
    st1 = g.args[0]
    gc = bench.loop(chain, st1, *rest, carry={0: state_of})
    chains = [t / chain_k for t in bench.times_ms(gc, chain_reps)]
    trust = torch.full((1,), cfg.trust_region, dtype=pr.x0s.dtype,
                       device=bench.dev)
    gg = bench.loop(gchain, st1, trust, *rest,
                    carry={0: state_of, 1: lambda out: out[1]})
    gticks = [t / gait_k for t in bench.times_ms(gg, cycles)]
    for lp in (g, gc, gg):
        lp.close()
    return {
        "single_solve_p50_ms": float(np.percentile(lats, 50)),
        "single_solve_p95_ms": float(np.percentile(lats, 95)),
        "single_solve_p99_ms": float(np.percentile(lats, 99)),
        "single_solve_ms": spread(lats),
        "device_resident_solve_ms": float(np.mean(chains)),
        "device_resident_p99_ms": float(np.percentile(chains, 99)),
        "device_resident_chain_k": chain_k,
        "device_resident_spread_ms": spread(chains),
        "gait_tick_batch1_ms": float(np.mean(gticks)),
        "gait_tick_batch1_spread_ms": spread(gticks),
        "gait_chain_k": gait_k,
    }


def noop_floor(bench: Bench, reps: int = 200) -> dict:
    """The floor under every replayed or launched call: a graph of one
    kernel replayed, and the same kernel launched eagerly."""
    import torch
    if not bench.cuda:
        return {"graph_noop_replay_p50_ms": None,
                "eager_noop_launch_p50_ms": None}
    z = torch.zeros(8, device=bench.dev)
    g = bench.loop(lambda v: v.add_(1.0), z)
    replay = bench.times_ms(g, reps)
    g.close()
    eager = bench.times_ms(lambda: z.add_(1.0), reps)
    return {"graph_noop_replay_p50_ms": float(np.median(replay)),
            "eager_noop_launch_p50_ms": float(np.median(eager))}


def ab_grid(bench: Bench, cfg, freq: int, m_cyc: int) -> dict:
    """bench.py's gait-opt A/B (:252-322): the standing A1 under a grid of
    mistimed trots; both arms run the same RTIs from ``create_initial_run``,
    the gait-on arm with the bilevel update in place of every
    ``freq``-th, then both settle and the converged trajectory costs are
    compared."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import cadence, solver
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    prs = [make_problem(cfg, 1, device=bench.dev, stretch=s)
           for s in AB_STRETCHES]
    B = len(prs)
    st = tree_map(lambda *a: torch.cat(a), *[p.states for p in prs])
    pr = prs[0]
    # the unperturbed standing state and feet (bench.py's x0, feet0)
    x_ab = pr.states.traj.x_man[:, 0].expand(B, -1).contiguous()
    f_ab = pr.feets.expand(B, -1, -1).contiguous()
    t_ab = pr.t0.expand(B).contiguous()
    xd_ab = pr.x_des.expand(B, -1).contiguous()
    st, _ = solver.create_initial_run(cfg, pr.params, st, x_ab, f_ab, xd_ab,
                                      t_ab)
    rest = (x_ab, t_ab, f_ab, xd_ab)

    def block(length):
        return bench.loop(lambda s, x, t, f, xd: cadence.rti_block(
            cfg, pr.params, s, x, t, f, xd, length), st, *rest)

    blk, step, settle = block(freq - 1), block(1), block(AB_SETTLE)
    trust = torch.full((B,), cfg.trust_region, dtype=x_ab.dtype,
                       device=bench.dev)
    gait = bench.loop(lambda s, tr, x, t, f, xd: cadence.gait_chain(
        cfg, pr.params, s, tr, x, t, f, xd, 1), st, trust, *rest)

    def run(loop, *args):
        """One call; its results cloned (a graph overwrites its own)."""
        return tree_map(torch.clone, loop(*args))

    st_on = st_off = st
    accepts = []
    for _ in range(m_cyc):
        st_on = run(blk, st_on, *rest)[0]
        st_on, trust, _, acc = run(gait, st_on, trust, *rest)
        accepts.append(acc.float().mean())
        st_off = run(blk, st_off, *rest)[0]
        st_off = run(step, st_off, *rest)[0]
    st_on = run(settle, st_on, *rest)[0]
    st_off = run(settle, st_off, *rest)[0]
    c_on = run(step, st_on, *rest)[1][0].double().cpu().numpy()
    c_off = run(step, st_off, *rest)[1][0].double().cpu().numpy()
    lens_on = torch.diff(st_on.traj.sched.bounds, dim=-1)
    lens_off = torch.diff(st_off.traj.sched.bounds, dim=-1)
    for lp in (blk, step, settle, gait):
        lp.close()
    return {
        "ab_stretch_grid": list(AB_STRETCHES),
        "ab_cost_gait_on": float(c_on.mean()),
        "ab_cost_gait_off": float(c_off.mean()),
        "ab_cost_reduction": float(c_off.mean() - c_on.mean()),
        "ab_scenario_wins": int((c_on < c_off).sum()),
        "ab_accept_rate": float(torch.stack(accepts).mean()),
        "ab_phase_len_moved": float(torch.amax(torch.abs(lens_on
                                                         - lens_off))),
        "ab_gait_opt_wins": bool(c_on.mean() < c_off.mean()),
    }


def n50(bench: Bench, cfg50, freq: int, cycles: int) -> dict:
    """bench.py's N=50 block at batch 32: 10 RTIs in a row, then the full
    cadence at that size."""
    from bilevel_gait_gen_tpu_torch.mpc import cadence
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    pr = make_problem(cfg50, N50_BATCH, device=bench.dev)
    rest = pr.loop_args()[1:]
    gb = bench.loop(lambda s, x, t, f, xd: cadence.rti_block(
        cfg50, pr.params, s, x, t, f, xd, N50_BLOCK), pr.states, *rest,
        carry={0: state_of})
    blk_ms = bench.times_ms(gb, cycles)
    gc = bench.loop(lambda s, x, t, f, xd: cadence.cycle(
        cfg50, pr.params, s, x, t, f, xd, freq), gb.args[0], *rest,
        carry={0: state_of})
    fracs = []
    cyc_ms = bench.times_ms(gc, cycles,
                            after=lambda: fracs.append(float(gc.out[3])))
    launches = getattr(gc, "captured_launches", None)
    for lp in (gb, gc):
        lp.close()
    b, c = np.mean(blk_ms), np.mean(cyc_ms)
    return {
        "n50_inner_rti_solves_per_s": N50_BATCH * N50_BLOCK / (b / 1e3),
        "n50_batch": N50_BATCH,
        "n50_batch_latency_ms": b / N50_BLOCK,
        "n50_bilevel_solves_per_s": N50_BATCH * freq / (c / 1e3),
        "n50_solved_frac": float(np.mean(fracs)),
        "n50_solved_frac_min": float(np.min(fracs)),
        "n50_rti_block_ms": spread(blk_ms),
        "n50_cadence_ms": spread(cyc_ms),
        "n50_cycle_captured_launches": launches,
    }


def card_record() -> tuple[str, float | None]:
    """The line ``nvidia-smi`` gives for the card's name and power limit,
    and the limit in watts."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable", None
    try:
        return line, float(line.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return line, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cycles", type=int, default=10,
                    help="timed calls of every cadence, block and chain")
    ap.add_argument("--single-reps", type=int, default=300)
    ap.add_argument("--chain-reps", type=int, default=60)
    ap.add_argument("--chain-k", type=int, default=20,
                    help="RTIs of a chained call (bench.py's K)")
    ap.add_argument("--gait-k", type=int, default=10,
                    help="gait updates of a chained call (bench.py's KG)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one eager and one graphed cycle (on the "
                    "card)")
    a = ap.parse_args(argv)

    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import torch
    if a.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for a run of "
                           "the control flow on the CPU)")
    from bilevel_gait_gen_tpu_torch.utils.precision import set_fp32_precision
    from bilevel_gait_gen_tpu_torch.ops.kernel_checks import check
    set_fp32_precision()
    bench = Bench(a.device)
    cfg = bench_config()
    batch = env_int("BENCH_BATCH", 128)
    freq = env_int("BENCH_GAIT_OPT_FREQ", 10)
    do_ab = os.environ.get("BENCH_AB", "1") != "0"
    do_n50 = os.environ.get("BENCH_N50", "1") != "0"
    cfg50 = n50_config(cfg) if do_n50 else None

    card, watts = card_record() if bench.cuda else ("cpu", None)
    print(card, flush=True)
    rows = []
    if bench.cuda:
        # every shape the run is about to give the kernels
        shapes = [(cfg, batch, f"N=20 batch {batch}"),
                  (cfg, 1, "N=20 batch 1")]
        if do_ab:
            shapes.append((cfg, len(AB_STRETCHES),
                           f"N=20 batch {len(AB_STRETCHES)} (A/B)"))
        if do_n50:
            shapes.append((cfg50, N50_BATCH, f"N=50 batch {N50_BATCH}"))
        for c, b, label in shapes:
            rows += check_kernels_at(c, b, label)
            torch.cuda.empty_cache()

    mode = "graphed" if bench.cuda else "eager (CPU)"
    res = cadence_n20(bench, cfg, batch, freq, a.cycles,
                      a.profile and bench.cuda)
    if bench.cuda and cfg.qp_kernel == "xla":
        # lane sweeps and polish sweeps, one gtwg and one ipm_iter launch
        # each (an exact sweep's M is formed once and handed on)
        want = cfg.ls_ipm_iters + cfg.ipm_grad_polish
        got = res["cycle_captured_launches"]
        check(got["gtwg"] == want and got["ipm_iter"] == want,
              f"the graphed cycle captured {got}, not {want} gtwg and "
              f"{want} ipm_iter launches")
    check(res["solved_frac"] >= SOLVED_MIN,
          f"solved_frac {res['solved_frac']:.4f} >= {SOLVED_MIN}")
    print(f"[cadence] batch {batch}: {mode} {res['value']:.1f} solves/s "
          f"({res['cadence_ms']['mean']:.2f} ms a cycle), eager "
          f"{res['eager_value']:.1f} ({res['eager_cadence_ms']['mean']:.2f}"
          f" ms); solved_frac {res['solved_frac']:.4f}", flush=True)
    res.update(single_robot(bench, cfg, a.single_reps, a.chain_reps,
                            a.chain_k, a.gait_k, a.cycles))
    res.update(noop_floor(bench))
    ab = ab_grid(bench, cfg, freq, env_int("BENCH_AB_CYCLES", 5)) \
        if do_ab else {}
    r50 = n50(bench, cfg50, freq, a.cycles) if do_n50 else {}
    if do_n50:
        check(r50["n50_solved_frac"] >= SOLVED_MIN,
              f"N=50 solved_frac {r50['n50_solved_frac']:.4f} >= "
              f"{SOLVED_MIN}")

    result = {
        "metric": "bilevel_mpc_solves_per_s_N20",
        "value": res.pop("value"),
        "unit": "solves/s",
        "batch": batch,
        "gait_opt_freq": freq,
        "cadence_mode": mode,
        **res,
        "rt_budget_ms": RT_BUDGET_MS,
        **ab,
        **r50,
        "kernel_checks": rows if bench.cuda else
        "skipped on the CPU: the wrappers run their plain versions",
        "device": torch.cuda.get_device_name(0) if bench.cuda else "cpu",
        "power_limit_w": watts,
        "nvidia_smi": card if bench.cuda else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "seconds": time.perf_counter() - t_start,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
