"""The port's host utilities (``utils/lowlevel_log.py``, ``utils/stats.py``,
``utils/timing.py``, ``utils/checkpoint.py``) against the JAX package's.

* LowLevelLog: the same records give the same file byte for byte, each
  package's ``load`` reads the other's file; a file whose last row is
  partial loads its complete rows in the port, where the JAX ``load``
  raises (pinned);
* the stats ring: rows recorded from a converted ``SolveStats`` equal the
  JAX ring's, wrap included, with no host data on the recording path, and
  ``print_table`` renders the JAX text character for character;
* timing: the host timers as tests/test_aux.py checks them, and
  ``device_trace`` writes a Chrome trace of the block;
* checkpoint: a converted ``SolverState`` saves the JAX ``save``'s
  ``leaf_i`` arrays, loads back bit for bit, and a template of another
  leaf count, leaf shape or structure raises ``StructureMismatch``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.mpc import gait as jgait, solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu.utils import checkpoint as jcheckpoint
from bilevel_gait_gen_tpu.utils import lowlevel_log as jll
from bilevel_gait_gen_tpu.utils import stats as jstats
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.mpc.solver import SolveStats
from bilevel_gait_gen_tpu_torch.utils import checkpoint, lowlevel_log as ll
from bilevel_gait_gen_tpu_torch.utils import stats, timing
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves, tree_map
from test_torch_cadence import no_host_data  # noqa: F401

torch.set_num_threads(2)

FIELDS = [("t", 1), ("q", 3), ("tau", 2)]


# ---------------------------------------------------------------------------
# LowLevelLog
# ---------------------------------------------------------------------------

def _write(mod, path, n, decimation=3, flush_every=256):
    rng = np.random.default_rng(0)
    with mod.LowLevelLog(str(path), fields=FIELDS, decimation=decimation,
                         flush_every=flush_every) as log:
        for i in range(n):
            log.record(t=np.asarray([0.1 * i]), q=rng.standard_normal(3),
                       tau=rng.standard_normal(2))


@pytest.mark.parametrize("n,decimation,flush_every",
                         [(10, 3, 256), (40, 1, 7)])
def test_lowlevel_log_files_are_the_jax_packages_bytes(tmp_path, n,
                                                       decimation,
                                                       flush_every):
    ours, theirs = tmp_path / "port.bggl", tmp_path / "jax.bggl"
    _write(ll, ours, n, decimation, flush_every)
    _write(jll, theirs, n, decimation, flush_every)
    assert ours.read_bytes() == theirs.read_bytes()
    for load in (ll.load, jll.load):
        a, b = load(str(ours)), load(str(theirs))
        assert a.keys() == b.keys() and a["decimation"] == decimation
        for name, _ in FIELDS:
            np.testing.assert_array_equal(a[name], b[name])
    got = ll.load(str(theirs))
    assert got["q"].shape == (len(range(0, n, decimation)), 3)
    np.testing.assert_allclose(got["t"][:, 0],
                               0.1 * np.arange(0, n, decimation), atol=1e-6)
    with pytest.raises(ValueError, match="expected 3 values"):
        with ll.LowLevelLog(str(tmp_path / "x.bggl"), fields=FIELDS) as log:
            log.record(t=[0.0], q=[1.0, 2.0], tau=[0.0, 0.0])


@pytest.mark.parametrize("extra_bytes", [8, 4 * 5, 6])
def test_lowlevel_log_load_keeps_the_complete_rows_of_a_partial_file(
        tmp_path, extra_bytes):
    """A writer stopped mid-row leaves 1-5 of a row's 6 floats, or a piece
    of a float: the port's load returns the complete rows; the JAX
    package's raises on the reshape."""
    path = tmp_path / "cut.bggl"
    _write(ll, path, 10)
    whole = ll.load(str(path))
    with open(path, "ab") as f:
        f.write(np.arange(6, dtype=np.float32).tobytes()[:extra_bytes])
    got = ll.load(str(path))
    for name, _ in FIELDS:
        np.testing.assert_array_equal(got[name], whole[name])
    if extra_bytes % 4 == 0:
        with pytest.raises(ValueError, match="reshape"):
            jll.load(str(path))


# ---------------------------------------------------------------------------
# the stats ring
# ---------------------------------------------------------------------------

def _solve_stats(rng):
    vals = rng.standard_normal(8) * 10.0 ** rng.integers(-6, 4, size=8)
    solved = bool(rng.random() < 0.7)
    jst = jsolver.SolveStats(*(jnp.asarray(v, jnp.float32) for v in vals),
                             jnp.asarray(solved))
    port = SolveStats(**{f: torch.tensor(np.asarray(getattr(jst, f)))[None]
                         for f in jsolver.SolveStats._fields})
    return jst, port


@pytest.fixture
def stats_inputs():
    rng = np.random.default_rng(1)
    return [(i, float(rng.uniform(0.1, 50.0))) + _solve_stats(rng)
            for i in range(12)]


def test_stats_ring_rows_and_table_are_the_jax_packages(
        capsys, stats_inputs, monkeypatch, no_host_data):
    """Recorded under the guard against host data (tests/
    test_torch_cadence.py); read back after it is lifted."""
    inputs = stats_inputs
    ring = stats.make_ring(capacity=8, device="cpu")
    jring = jstats.make_ring(capacity=8)
    for i, ms, jst, port in inputs:              # 12 rows wrap a ring of 8
        ring = stats.record(ring, i, ms, port)
        jring = jstats.record(jring, i, ms, jst)
    monkeypatch.undo()
    assert int(ring.head) == int(jring.head) == 12
    assert ring.head.dtype == torch.int32
    np.testing.assert_array_equal(ring.data.numpy(), np.asarray(jring.data))
    for last in (4, 20):
        ours = stats.print_table(ring, last=last)
        theirs = jstats.print_table(jring, last=last)
        assert ours == theirs
    out = capsys.readouterr().out
    assert "defect_l1" in out
    # a tensor index and time record as numbers do
    ring2 = stats.record(stats.make_ring(4, torch.float64, "cpu"),
                         torch.tensor(3, dtype=torch.int32),
                         torch.tensor(2.5, dtype=torch.float64), inputs[0][3])
    ring3 = stats.record(stats.make_ring(4, torch.float64, "cpu"), 3, 2.5,
                         inputs[0][3])
    assert torch.equal(ring2.data, ring3.data)


def test_stats_record_refuses_a_batch_of_more_than_one():
    _, port = _solve_stats(np.random.default_rng(2))
    two = SolveStats(**{f: torch.cat([getattr(port, f)] * 2)
                        for f in jsolver.SolveStats._fields})
    with pytest.raises(RuntimeError):
        stats.record(stats.make_ring(4, device="cpu"), 0, 1.0, two)


def test_print_table_appends_to_a_file(tmp_path):
    _, port = _solve_stats(np.random.default_rng(3))
    ring = stats.record(stats.make_ring(4, device="cpu"), 0, 1.0, port)
    path = tmp_path / "stats.txt"
    text = stats.print_table(ring, file=str(path))
    stats.print_table(ring, file=str(path))
    assert path.read_text() == (text + "\n") * 2


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def test_timers():
    st = timing.StageTimers()
    for _ in range(2):
        with st.stage("a"):
            pass
    with st.stage("b"):
        pass
    assert st.counts["a"] == 2 and st.counts["b"] == 1
    assert "a" in st.summary() and st.summary().splitlines()[0].startswith(
        "stage")
    t = timing.Timer("x")
    t.start()
    assert t.stop() >= 0.0 and t.elapsed_ms >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64, dtype=torch.float64)
    with timing.device_trace(str(tmp_path)):
        (a @ a).sum()
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(
        traces[0].read_text())["traceEvents"]}
    assert "aten::mm" in names
    with pytest.raises(KeyError):
        with timing.device_trace(str(tmp_path / "raised")):
            raise KeyError("inside the block")
    assert len(list((tmp_path / "raised").glob("trace_*.json"))) == 1


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _jax_states():
    cfg = MPCConfig(num_nodes=6, num_phase_slots=4,
                    phase_duration=0.5).validate()
    x0 = jnp.zeros(13).at[2].set(0.3).at[9].set(1.0)
    traj = default_trajectory(cfg, jgait.make_trot(cfg), x0,
                              jnp.zeros((4, 2)))
    box = jnp.asarray(cfg.ee_box_size)
    return {"cold": jsolver.SolverState(traj=traj, ee_box=box),
            "warm": jsolver.make_state(cfg, traj, box)}


@pytest.mark.parametrize("kind", ["cold", "warm"])
def test_checkpoint_saves_the_jax_packages_leaves(tmp_path, kind):
    jst = _jax_states()[kind]
    st = convert.from_solver_state(jst, device="cpu")
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save(ours, st, metadata={"t": 1.25})
    jcheckpoint.save(theirs, jst, metadata={"t": 1.25})
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) == len(jax.tree.leaves(jst))
        for name in b.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    side = json.loads(open(ours + ".json").read())
    assert side["num_leaves"] == len(tree_leaves(st))
    assert checkpoint.metadata(ours) == {"t": 1.25}
    back = checkpoint.load(ours, tree_map(torch.zeros_like, st))
    for x, y in zip(tree_leaves(back), tree_leaves(st)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_orders_dict_entries_as_jax_does(tmp_path):
    rng = np.random.default_rng(4)
    src = {"b": rng.standard_normal(3), "a": rng.standard_normal((2, 2)),
           "c": {"z": rng.standard_normal(1), "y": rng.standard_normal(4)}}
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save(ours, jax.tree.map(torch.tensor, src))
    jcheckpoint.save(theirs, jax.tree.map(jnp.asarray, src))
    with np.load(ours) as a, np.load(theirs) as b:
        for name in b.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_checkpoint_structure_mismatch(tmp_path):
    """The same leaf count with another structure, another leaf shape, or
    another leaf count raises; the template's own structure loads."""
    p = str(tmp_path / "ckpt.npz")
    src = {"a": torch.ones(3), "b": torch.zeros(2, 2)}
    checkpoint.save(p, src)
    with pytest.raises(checkpoint.StructureMismatch, match="structure"):
        checkpoint.load(p, {"x": torch.ones(3), "y": torch.zeros(2, 2)})
    with pytest.raises(checkpoint.StructureMismatch, match="shape"):
        checkpoint.load(p, {"a": torch.ones(4), "b": torch.zeros(2, 2)})
    with pytest.raises(checkpoint.StructureMismatch, match="leaves"):
        checkpoint.load(p, {"a": torch.ones(3)})
    back = checkpoint.load(p, tree_map(torch.zeros_like, src))
    assert torch.equal(back["a"], src["a"])
    assert back["b"].dtype == torch.float32
