"""The port's four scripts that stand on ``parallel/`` (scripts/
torch_multihost_demo.py, torch_multihost_scaling.py, torch_distr_rejection.py,
torch_bench_sweep.py), on the CPU.

* the demo end to end (two ``gloo`` processes on a ``FileStore``):
  ``MULTIHOST OK`` and two equal "mean cost" lines (the counterpart of
  tests/test_parallel.py:115-128 and tests/test_multihost.py:21-32), the
  mean equal to the port's unsharded step on the same four scenarios;
* the scaling sweep at n in {1, 2} with a short chain, written to a
  temporary path: well-formed rows, positive rates, nothing else written
  and no SCALING.json named in the script's code;
  the counterpart of the JAX package's >= 0.8 efficiency gate at two
  processes carries ``slow``, as tests/test_multihost.py does (its module is
  slow in tests/conftest.py);
* distr_rejection's and bench_sweep's setup at a tiny batch against the
  lines of the JAX scripts that build it (float64, 1e-12 of each array's
  magnitude; the pushes and perturbations are drawn with numpy in the port,
  so the JAX side is given the port's draws), then their run at that batch;
  distr_rejection's ``--closed-loop`` parsing and verdict on a stand-in
  result (the MuJoCo run itself is tests/test_torch_closed_loop*.py's).
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait, solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory as jdeft
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch.mpc import solver
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
from test_torch_demos import assert_rel, script

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
F64 = torch.float64
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def _run(name, *args, timeout=300, cwd=ROOT):
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / name),
                          *args], capture_output=True, text=True,
                         timeout=timeout, env=ENV, cwd=cwd)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_multihost_demo_two_processes():
    out = _run("torch_multihost_demo.py", "--cpu")
    assert "MULTIHOST OK" in out, out
    lines = [ln for ln in out.splitlines() if "mean cost" in ln]
    assert len(lines) == 2, out
    means = {ln.split("mean cost ")[1].split(",")[0] for ln in lines}
    assert len(means) == 1, lines
    # the gathered mean is the unsharded step's over the same 4 scenarios
    demo = script("torch_multihost_demo")
    cfg = demo.small_config()
    parts = [demo.local_batch(cfg, pid, "cpu") for pid in range(2)]
    params, x_des = parts[0][0], parts[0][4]
    states, x0s, feets = (tree_map(lambda *a: torch.cat(a),
                                   *[p[k] for p in parts]) for k in (1, 2, 3))
    _, stats = solver.solve_step(cfg, params, states, x0s,
                                 torch.zeros(4), feets, x_des.expand(4, -1))
    assert f"{float(stats.cost.mean()):.2f}" in means


def _scaling(tmp_path, *args):
    """The script's rows, run from an empty directory: it writes ``--out``
    and nothing beside it, and its code names no SCALING.json (the JAX
    package's record, which tests/test_multihost.py rewrites)."""
    source = ast.parse((ROOT / "scripts" / "torch_multihost_scaling.py")
                       .read_text())
    doc = ast.get_docstring(source, clean=False)
    assert not [n.value for n in ast.walk(source)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value != doc and "SCALING.json" in n.value]
    cwd = tmp_path / "cwd"
    cwd.mkdir(exist_ok=True)
    path = tmp_path / "scaling.json"
    out = _run("torch_multihost_scaling.py", "--cpu", f"--out={path}",
               *args, timeout=600, cwd=cwd)
    assert "SCALING OK" in out, out
    assert not list(cwd.iterdir())
    return json.loads(path.read_text())["rows"]


def test_scaling_rows_are_well_formed(tmp_path):
    rows = _scaling(tmp_path, "--ns=1,2", "--steps=3", "--reps=1")
    assert [r["n_procs"] for r in rows] == [1, 2]
    assert [r["global_batch"] for r in rows] == [4, 8]
    assert all(r["solves_per_s"] > 0 for r in rows)
    assert rows[0]["efficiency"] == 1.0
    assert rows[1]["efficiency"] == pytest.approx(
        rows[1]["solves_per_s"] / (2 * rows[0]["solves_per_s"]))


@pytest.mark.slow
def test_scaling_efficiency_at_two_processes(tmp_path):
    """tests/test_multihost.py:35-59's gate on the port: >= 0.8 parallel
    efficiency at two processes (one pinned core each), one retry."""
    for _ in range(2):
        rows = _scaling(tmp_path, "--ns=1,2")
        eff2 = next(r["efficiency"] for r in rows if r["n_procs"] == 2)
        if eff2 >= 0.8:
            break
    assert eff2 >= 0.8, rows


# ---------------------------------------------------------------------------
# distr_rejection and bench_sweep
# ---------------------------------------------------------------------------

def _jax_stand():
    jm = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    params = jsrb.make_srb_params(jm, q0)
    feet0 = jrbd.ee_positions(jm, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(jm.nv))
    return params, feet0, x0


def _same_config(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def test_distr_rejection_setup_matches_the_jax_script():
    """distr_rejection.py:84-112 with the port's pushes."""
    dr = script("torch_distr_rejection")
    case = dr.setup(3, "cpu", F64)
    jcfg = MPCConfig(num_nodes=50, dt=0.02, ipm_iters=18,
                     force_bound=200.0, friction_coef=0.6, force_cost=0.001,
                     q_diag=(140.0, 140.0, 12000.0, 0.015, 0.015, 10.0,
                             3000.0, 3000.0, 3000.0, 1.0, 1.0,
                             1.0)).validate()
    _same_config(case["cfg"], jcfg)
    params, feet0, x_nom = _jax_stand()
    sp = case["speeds"]
    assert sp.shape == (3,) and (sp >= 0).all() and (sp < 2.5).all()
    v = case["x0s"][:, 3:5].numpy() / float(params.mass)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), sp, rtol=1e-12)
    x0s = np.tile(np.asarray(x_nom), (3, 1))
    x0s[:, 3:5] = case["x0s"][:, 3:5].numpy()
    assert_rel(case["x0s"], x0s, 1e-12, "x0s")
    traj = jdeft(jcfg, jgait.make_trot(jcfg), x_nom, feet0[:, :2])
    for name in ("x_man", "f_nodes", "footholds"):
        assert_rel(getattr(case["states"].traj, name),
                   np.stack([np.asarray(getattr(traj, name))] * 3), 1e-12,
                   name)
    assert_rel(case["feets"], np.stack([np.asarray(feet0)] * 3), 1e-12)
    assert_rel(case["x_des"], jsrb.manifold_to_tangent(x_nom), 1e-12)


def test_distr_rejection_plans_a_tiny_batch(capsys):
    dr = script("torch_distr_rejection")
    res = dr.report(dr.plan(dr.setup(2, "cpu"), "cpu"))
    out = capsys.readouterr().out
    assert "ranks: 1  batch: 2" in out and "MPC solves/s" in out
    assert res["solved"] == 1.0 and res["solves_per_s"] > 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("speeds, code", [((0.375,), 0), ((0.3, 0.35), 1)])
def test_distr_rejection_closed_loop_mode(monkeypatch, capsys, speeds,
                                          code):
    """``--vx`` and ``--sweep`` parsing and the verdict, on stand-in results
    of ``run_push_recovery`` (upright and arrested at 0.375 m/s, fallen at
    0.35)."""
    from bilevel_gait_gen_tpu_torch.sim import closed_loop
    dr = script("torch_distr_rejection")
    seen = []

    def fake(init_vx, seconds, device):
        seen.append(init_vx)
        z = 0.3 if init_vx < 0.32 or init_vx > 0.36 else 0.05
        qs = np.zeros((600, 19))
        qs[:, 2] = z
        return closed_loop.ClosedLoopResult(
            qs=qs, vs=np.zeros((600, 18)), taus=np.zeros((600, 12)),
            n_mpc=3, n_fails=0, n_gait_accepts=0)

    monkeypatch.setattr(closed_loop, "run_push_recovery", fake)
    argv = (["--closed-loop", "--vx=0.375"] if len(speeds) == 1 else
            ["--closed-loop", "--sweep=0.3:0.35:0.05"])
    assert dr.main(argv + ["--cpu"]) == code
    np.testing.assert_allclose(seen, speeds)
    out = capsys.readouterr().out
    assert ("RECOVERED" in out) and (("FELL" in out) == bool(code))


def test_bench_sweep_setup_matches_the_jax_script():
    """bench_sweep.py:29-46 with the port's perturbations."""
    bs = script("torch_bench_sweep")
    case = bs.setup(3, "pallas", "cpu", F64)
    jcfg = MPCConfig(ipm_iters=10, ipm_exact_every=3,
                     qp_kernel="pallas").validate()
    _same_config(case["cfg"], jcfg)
    params, feet0, x0 = _jax_stand()
    states, x0s, t0, feets, x_des = case["args"]
    traj = jdeft(jcfg, jgait.make_trot(jcfg), x0, feet0[:, :2])
    jst = jsolver.make_state(jcfg, traj, jnp.asarray(jcfg.ee_box_size))
    for name in ("x_man", "f_nodes", "footholds"):
        assert_rel(getattr(states.traj, name),
                   np.stack([np.asarray(getattr(traj, name))] * 3), 1e-12,
                   name)
    for f in ("x", "y", "lam", "s", "pri_res"):
        assert_rel(getattr(states.qp_warm, f),
                   np.stack([np.asarray(getattr(jst.qp_warm, f))] * 3),
                   1e-12, f)
    d = x0s.numpy() - np.asarray(x0)
    assert (d[:, 6:10] == 0).all() and 0 < np.abs(d).max() < 0.2
    assert t0 == 0.0
    assert_rel(feets, np.stack([np.asarray(feet0)] * 3), 1e-12)
    assert_rel(x_des, jsrb.manifold_to_tangent(x0), 1e-12)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_bench_sweep_runs_a_tiny_batch(capsys, kernel):
    res = script("torch_bench_sweep").run(2, kernel, "cpu", n_rep=1)
    assert res["solved"] == 1.0 and res["solves_per_s"] > 0
    assert f"kernel={kernel}" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_distr_rejection",
                                  "torch_bench_sweep"])
def test_scripts_refuse_to_run_on_the_cpu_unasked(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script(name).main(["2"])
