"""The port's ``parallel/`` (``mesh``, ``multihost``) against the JAX
package's, float64 on the CPU, at the small configuration of
tests/test_parallel.py:23-25, every call with ``device="cpu"``.

One launch of four ``gloo`` ranks (tests/torch_parallel_worker.py, a
``FileStore`` in a temporary directory) on a {scenario: 2, alpha: 2} mesh
computes three results, each gathered over the scenario axis:
``batched_solve_step`` on a sharded batch of 8, the alpha-sharded gait
update (``ls_alphas=4``) at B=2, and the scenario-sharded closed loop at
B=8 for 40 ticks.

* the sharded step and closed loop against the port's unsharded calls
  within 1e-9 (the same float64 arithmetic on a smaller batch);
* the sharded step against the JAX ``batched_solve_step`` on inputs
  sharded over the 8-device mesh, and the sharded gait update against the
  JAX ``alpha_sharded_gait_opt_update`` on its (2, 4) mesh, at the bounds
  tests/test_torch_bilevel.py holds ``solve_step`` and ``gait_opt_update``
  to (decisions equal, trajectories to 1e-6, costs to rtol 1e-6, the
  schedule to 1e-9);
* the alpha ranks of a scenario shard hold the same result bit for bit;
* in this process: a one-rank lane group gives the update without a group
  bit for bit; the divisibility errors; ``initialize``'s ``None`` rules.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bilevel_gait_gen_tpu.control import wbqp as jwbqp
from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait, solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu.parallel import mesh as jmesh
from bilevel_gait_gen_tpu.sim import engine as jengine
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.models import a1
from bilevel_gait_gen_tpu_torch.mpc import bilevel, solver
from bilevel_gait_gen_tpu_torch.parallel import mesh as mesh_mod
from bilevel_gait_gen_tpu_torch.parallel import multihost
from bilevel_gait_gen_tpu_torch.sim import engine
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves, tree_map

torch.set_num_threads(2)

F64 = torch.float64
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
CFG = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                init_run_iters=2, max_ls_iters=4, dt=0.05).validate()
# 4 lanes, one per rank of the JAX (2, 4) mesh's alpha axis; 16-sweep lanes
# so that the cold lane solves pass the quality gate at this size (as in
# tests/test_torch_bilevel.py: with 4 sweeps no lane passes it, and the
# comparison would see only the rejections)
CFG4 = dataclasses.replace(CFG, ls_alphas=4, ls_ipm_iters=16)
LOOP = dict(n_ticks=40, control_dt=0.005, mpc_every=20)


def _port(a):
    return convert.tensor(a, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def case():
    """The inputs, built once in JAX (float64) and converted: the step's
    cold batch of 8, the gait update's batch of 2 after the port's initial
    run, the closed loop's batch of 8 on the settled stand."""
    jm = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    params = jsrb.make_srb_params(jm, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(jm.nv))
    feet0 = jrbd.ee_positions(jm, q0)
    traj = default_trajectory(CFG, jgait.make_trot(CFG), x0, feet0[:, :2])
    st = jsolver.SolverState(traj=traj,
                             ee_box=jnp.asarray(CFG.ee_box_size, jnp.float64))
    x_des = jsrb.manifold_to_tangent(x0)
    rng = np.random.default_rng(0)

    def batch(tree, n):
        return jax.tree.map(lambda a: jnp.stack([a] * n), tree)

    def pert(n):
        p = 0.01 * rng.standard_normal((n, 13))
        p[:, 6:10] = 0.0
        return x0[None] + p

    pparams = convert.from_srb_params(params, device="cpu", dtype=F64)
    pcfg, pcfg4 = convert.from_config(CFG), convert.from_config(CFG4)
    step = dict(cfg=pcfg, params=pparams, t0=0.0, x_des=_port(x_des),
                jstates=batch(st, 8), jx0s=pert(8), jfeets=batch(feet0, 8))
    step.update(states=convert.from_solver_state(step["jstates"],
                                                 device="cpu", dtype=F64),
                x0s=_port(step["jx0s"]), feets=_port(step["jfeets"]))

    # the gait update starts from the port's initial run (shared by both
    # packages' updates: the JAX state is built from it)
    st1 = convert.from_solver_state(batch(st, 1), device="cpu", dtype=F64)
    st1, stats = solver.create_initial_run(
        pcfg4, pparams, st1, _port(x0[None]), _port(feet0[None]),
        _port(x_des[None]))
    assert bool(stats.solved.all())
    gstates = tree_map(lambda a: a.repeat_interleave(2, 0), st1)
    jgx0s = pert(2)
    gait = dict(cfg=pcfg4, params=pparams, states=gstates,
                x0s=_port(jgx0s), t0=0.0, feets=_port(batch(feet0, 2)),
                x_des=_port(x_des), jstates=_jax_state(gstates),
                jx0s=jgx0s, jfeets=batch(feet0, 2))

    jsim = jengine.SimConfig()
    q0s = jengine.settled_stand(jm, jsim, q0)
    v0s = np.zeros((8, jm.nv))
    v0s[:, 0] = np.linspace(-0.1, 0.1, 8)
    loop = dict(model=a1.make_a1(device="cpu"), params=pparams,
                cfg=pcfg, wb_cfg=convert.from_wbqp_config(jwbqp.WBQPConfig()),
                sim=convert.from_sim_config(jsim), kw=LOOP,
                states=step["states"], q0s=_port(batch(q0s, 8)),
                v0s=_port(v0s), xds=_port(batch(x_des, 8)))
    return dict(step=step, gait=gait, loop=loop, jparams=params)


def _jax_state(st):
    """A port SolverState (batch first) as the JAX package's."""
    from bilevel_gait_gen_tpu.mpc.gait import GaitSchedule as JSched
    from bilevel_gait_gen_tpu.mpc.trajectory import Trajectory as JTraj
    from bilevel_gait_gen_tpu.ops import pdip as jpdip
    tr = convert.to_numpy(st.traj)
    warm = None
    if st.qp_warm is not None:
        w = convert.to_numpy(st.qp_warm)
        warm = jpdip.QPSolution(*(jnp.asarray(getattr(w, f))
                                  for f in jpdip.QPSolution._fields))
    return jsolver.SolverState(
        traj=JTraj(x_man=jnp.asarray(tr.x_man),
                   f_nodes=jnp.asarray(tr.f_nodes),
                   footholds=jnp.asarray(tr.footholds),
                   sched=JSched(bounds=jnp.asarray(tr.sched.bounds))),
        ee_box=jnp.asarray(convert.to_numpy(st.ee_box)), qp_warm=warm)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """The four ranks' results (tests/torch_parallel_worker.py)."""
    d = tmp_path_factory.mktemp("gloo4")
    port = {k: {n: v for n, v in case[k].items() if not n.startswith("j")}
            for k in ("step", "gait", "loop")}
    torch.save(port, d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(d), str(r),
                               "4"], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(outs)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


def _same_bits(a, b) -> bool:
    """Every tensor of ``a`` equal to its place in ``b`` bit for bit (NaNs
    included)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) > 0 and all(
        x.dtype == y.dtype and torch.equal(
            x.view(torch.int64) if x.dtype == F64 else x,
            y.view(torch.int64) if y.dtype == F64 else y)
        for x, y in zip(la, lb))


def _np(t):
    return t.detach().numpy()


def _assert_tree_close(got, want, atol):
    lg, lw = tree_leaves(got), tree_leaves(want)
    assert len(lg) == len(lw) > 0
    for a, b in zip(lg, lw):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(_np(a), _np(b))


def test_sharded_step_matches_unsharded_port(case, ranks):
    s = case["step"]
    want = solver.solve_step(s["cfg"], s["params"], s["states"], s["x0s"],
                             torch.zeros(8, dtype=F64), s["feets"],
                             s["x_des"].expand(8, -1))
    _assert_tree_close(ranks[0]["step"], want, 1e-9)


def test_sharded_step_matches_jax_on_a_sharded_batch(case, ranks):
    """tests/test_torch_bilevel.py's solve_step bounds against the JAX
    batched_solve_step on inputs sharded over the 8-device mesh."""
    s = case["step"]
    jmesh8 = jmesh.make_mesh((8,), ("scenario",))
    jstep = jmesh.batched_solve_step(CFG, case["jparams"])
    jst, jstats = jstep(*(jmesh.shard_batch(a, jmesh8) for a in (
        s["jstates"], jnp.asarray(s["jx0s"]))), jnp.asarray(0.0),
        jmesh.shard_batch(s["jfeets"], jmesh8),
        jnp.asarray(convert.to_numpy(s["x_des"])))
    st, stats = ranks[0]["step"]
    np.testing.assert_array_equal(_np(stats.solved), np.asarray(jstats.solved))
    np.testing.assert_array_equal(_np(stats.alpha), np.asarray(jstats.alpha))
    for name in ("x_man", "f_nodes", "footholds"):
        np.testing.assert_allclose(_np(getattr(st.traj, name)),
                                   np.asarray(getattr(jst.traj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    for f in dataclasses.fields(stats):
        if f.name not in ("solved", "alpha"):
            np.testing.assert_allclose(_np(getattr(stats, f.name)),
                                       np.asarray(getattr(jstats, f.name)),
                                       rtol=1e-6, atol=1e-9, err_msg=f.name)


def test_alpha_sharded_gait_update_matches_jax(case, ranks):
    """The port's update on the {scenario: 2, alpha: 2} mesh against the
    JAX alpha_sharded_gait_opt_update on its (2, 4) mesh."""
    g = case["gait"]
    jmesh24 = jmesh.make_mesh((2, 4), ("scenario", "alpha"))
    jres = jmesh.alpha_sharded_gait_opt_update(CFG4, case["jparams"],
                                               jmesh24)(
        g["jstates"], jnp.asarray(g["jx0s"]), jnp.asarray(0.0),
        g["jfeets"], jnp.asarray(convert.to_numpy(g["x_des"])))
    res = ranks[0]["gait"]
    np.testing.assert_array_equal(_np(res.accepted), np.asarray(jres.accepted))
    np.testing.assert_array_equal(_np(res.alpha), np.asarray(jres.alpha))
    for name in ("cost", "cost0", "grad_norm", "trust"):
        np.testing.assert_allclose(_np(getattr(res, name)),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(_np(res.state.traj.sched.bounds),
                               np.asarray(jres.state.traj.sched.bounds),
                               rtol=0, atol=1e-9)
    assert np.isfinite(_np(res.win_obj)).any()


def test_alpha_sharded_gait_update_matches_unsharded_port(case, ranks):
    g = case["gait"]
    want = bilevel.gait_opt_update(g["cfg"], g["params"], g["states"],
                                   g["x0s"], torch.zeros(2, dtype=F64),
                                   g["feets"], g["x_des"].expand(2, -1))
    _assert_tree_close(ranks[0]["gait"], want, 1e-9)


def test_sharded_closed_loop_matches_unsharded_port(case, ranks):
    """Also tests/test_parallel.py:171-199's contract: finite, upright
    (z > 0.10 m), every MPC tick solved."""
    lp = case["loop"]
    want = engine.closed_loop(lp["model"], lp["params"], lp["cfg"],
                              lp["wb_cfg"], lp["sim"], lp["states"],
                              lp["q0s"], lp["v0s"], lp["xds"], **LOOP)
    st, log = ranks[0]["loop"]
    _assert_tree_close((st, log), want, 1e-9)
    q = _np(log.q)
    assert log.q.shape[:2] == (LOOP["n_ticks"], 8)
    assert np.isfinite(q).all()
    assert (q[:, :, 2].min(axis=0) > 0.10).all()
    cost = _np(log.cost)
    assert _np(log.solved)[np.isfinite(cost)].all()


@pytest.mark.parametrize("what", ["step", "gait", "loop"])
def test_alpha_ranks_hold_the_same_result(ranks, what):
    """Ranks 0 and 1 (2 and 3) share a scenario shard; after the gathers
    every rank holds the same global result bit for bit."""
    for r in ranks[1:]:
        assert _same_bits(ranks[0][what], r[what])


def test_divisibility_errors(ranks):
    """ls_alphas=3 over 2 alpha ranks, and a batch of 3 over 2 scenario
    ranks, raise ValueError (JAX asserts the first, bilevel.py:385-386)."""
    for r in ranks:
        assert "ls_alphas=3 must be divisible" in r["lanes_error"]
        assert "a batch of 3 does not divide" in r["batch_error"]


@pytest.fixture
def one_rank():
    """A process group of this process alone (``multihost.one_rank_group``,
    gloo), torn down after the test."""
    with multihost.one_rank_group(device="cpu"):
        yield
    assert not dist.is_initialized()


def test_one_rank_lane_group_equals_no_group_bitwise(case, one_rank):
    g = case["gait"]
    args = (g["cfg"], g["params"], g["states"], g["x0s"],
            torch.zeros(2, dtype=F64), g["feets"], g["x_des"].expand(2, -1))
    want = bilevel.gait_opt_update(*args)
    got = bilevel.gait_opt_update(*args, ls_group=dist.group.WORLD)
    mesh = mesh_mod.make_mesh((1, 1), ("scenario", "alpha"), device="cpu")
    sharded = mesh_mod.alpha_sharded_gait_opt_update(g["cfg"], g["params"],
                                                     mesh)(
        g["states"], g["x0s"], 0.0, g["feets"], g["x_des"])
    assert _same_bits(got, want)
    assert _same_bits(tree_map(lambda d: d.to_local(), sharded), want)


def test_initialize_none_rules(tmp_path, monkeypatch):
    """No coordinator (and no MASTER_ADDR) joins nothing and returns False;
    an explicit process_id=0 is not overridden by RANK=1."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert multihost.initialize(f"file://{tmp_path}/store", 1, 0,
                                device="cpu")
    try:
        assert dist.get_rank() == 0 and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_make_mesh_without_a_group_is_one_rank_on_the_cpu():
    """Without a process group ``make_mesh`` raises (it starts none behind
    the caller's back); in ``one_rank_group`` it is a mesh of one rank on
    the CPU, and the group is gone after the block."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh_mod.make_mesh(device="cpu")
    with multihost.one_rank_group(device="cpu") as group:
        mesh = mesh_mod.make_mesh(device="cpu")
        assert mesh.device_type == "cpu" and mesh.size() == 1
        assert mesh.mesh_dim_names == ("scenario",)
        assert dist.get_backend(group) == "gloo"
        with pytest.raises(RuntimeError, match="already initialized"):
            with multihost.one_rank_group(device="cpu"):
                pass
    assert not dist.is_initialized()
