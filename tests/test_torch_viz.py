"""The port's ``sim/viz.py`` against the JAX package, float64.

Each figure is captured where it is saved (``Figure.savefig`` patched to
render into memory): the PNG is more than 1000 bytes, as
tests/test_viz.py checks the JAX package's, and every plotted line holds
the data it should.  The plan's sampled splines are held to the JAX
package's ``spline.forces_all`` / ``foot_positions_all`` at the same
``np.linspace`` times, each computed with one ``jax.vmap`` over the times,
to 1e-10 of the line's largest magnitude; the node states, footholds and
the executed path are the trajectory's own numbers, bit for bit.  The plan
is given without its batch dimension and with a batch of one.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib.figure import Figure

from bilevel_gait_gen_tpu.models import a1 as ja1, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory as jdeft
from bilevel_gait_gen_tpu.ops import spline as jspline
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.sim import viz
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map

torch.set_num_threads(2)

CFG = MPCConfig().validate()
PCFG = convert.from_config(CFG)
T0 = 0.13


@pytest.fixture
def figures(monkeypatch):
    """The figures saved while the test runs: (figure, path, PNG bytes)."""
    saved = []
    real = Figure.savefig

    def capture(self, path, **kw):
        buf = io.BytesIO()
        real(self, buf, format="png", **kw)
        saved.append((self, path, buf.getvalue()))

    monkeypatch.setattr(Figure, "savefig", capture)
    return saved


@pytest.fixture(scope="module")
def plan():
    """A trot plan with seeded force nodes and footholds (the JAX package's
    trajectory, float64), and the JAX package's SRB parameters."""
    rng = np.random.default_rng(0)
    model = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config())
    params = jsrb.make_srb_params(model, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(model.nv))
    traj = jdeft(CFG, jgait.make_trot(CFG), x0, jnp.zeros((4, 2)))
    traj = traj.__class__(
        x_man=traj.x_man + 0.01 * rng.standard_normal(traj.x_man.shape),
        f_nodes=jnp.asarray(40.0 * rng.standard_normal(traj.f_nodes.shape)),
        footholds=jnp.asarray(0.2 * rng.standard_normal(
            traj.footholds.shape)),
        sched=traj.sched)
    return traj, params


def jax_samples(traj, ts):
    """(forces [T, E, 3], feet [T, E, 3]) of the JAX package, one vmap over
    the times each."""
    b = traj.sched.bounds
    forces = jax.vmap(lambda t: jspline.forces_all(
        b, traj.f_nodes, t, CFG.num_force_polys))(jnp.asarray(ts))
    feet = jax.vmap(lambda t: jspline.foot_positions_all(
        b, traj.footholds, t, CFG.swing_height, CFG.foot_offset))(
        jnp.asarray(ts))
    return np.asarray(forces), np.asarray(feet)


def port_plan(traj, batched):
    pt = convert.from_trajectory(traj, device="cpu")
    return tree_map(lambda a: a[None], pt) if batched else pt


def assert_line(line, x, y, rtol=1e-10):
    gx, gy = np.asarray(line.get_xdata()), np.asarray(line.get_ydata())
    np.testing.assert_array_equal(gx, x)
    np.testing.assert_allclose(gy, y, rtol=0,
                               atol=rtol * max(np.abs(y).max(), 1.0))


def test_plot_rollout(figures, tmp_path):
    qs = np.random.default_rng(0).standard_normal((50, 19)) * 0.01
    qs[:, 2] += 0.3
    taus = np.random.default_rng(1).standard_normal((50, 12))
    path = str(tmp_path / "r.png")
    assert viz.plot_rollout(qs, taus, dt=0.002, path=path) == path
    (fig, saved_to, png), = figures
    assert saved_to == path and len(png) > 1000
    ax = fig.axes
    t = np.arange(50) * 0.002
    for i in range(3):
        assert_line(ax[0].lines[i], t, qs[:, i], rtol=0)
    for i in range(4):
        assert_line(ax[1].lines[i], t, qs[:, 3 + i], rtol=0)
    assert_line(ax[2].lines[0], t, np.abs(taus).max(axis=1), rtol=0)


@pytest.mark.parametrize("batched", [False, True],
                         ids=["unbatched", "batch_of_one"])
def test_plot_plan_lines_are_the_jax_splines(figures, plan, batched):
    traj, _ = plan
    viz.plot_plan(port_plan(traj, batched), PCFG, t0=T0, path="plan.png")
    (fig, _, png), = figures
    assert len(png) > 1000
    ts = np.linspace(T0, T0 + CFG.horizon, 200)
    forces, feet = jax_samples(traj, ts)
    ax = fig.axes
    xs = np.asarray(traj.x_man)
    assert_line(ax[0].lines[0], T0 + CFG.dt * np.arange(xs.shape[0]),
                xs[:, 2], rtol=0)
    assert len(ax[1].lines) == len(ax[2].lines) == CFG.num_ee
    for e in range(CFG.num_ee):
        assert_line(ax[1].lines[e], ts, forces[:, e, 2])
        assert_line(ax[2].lines[e], ts, feet[:, e, 2])
    # the seeded forces and swings move the lines: the check has teeth
    assert np.ptp(forces[..., 2]) > 10.0 and np.ptp(feet[..., 2]) > 0.01


@pytest.mark.parametrize("batched", [False, True],
                         ids=["unbatched", "batch_of_one"])
def test_plot_plan_overlay_lines_are_the_jax_splines(figures, plan, batched):
    traj, params = plan
    pparams = convert.from_srb_params(params, device="cpu")
    qs = np.tile(np.asarray(ja1.stand_config())[None], (40, 1))
    qs[:, 0] += np.linspace(0.0, 0.1, 40)
    viz.plot_plan_overlay(port_plan(traj, batched), PCFG, pparams, qs,
                          t0=T0, path="overlay.png")
    (fig, _, png), = figures
    assert len(png) > 1000
    ts = np.linspace(T0, T0 + CFG.horizon, 100)
    _, feet = jax_samples(traj, ts)
    ax, = fig.axes
    xs, fh = np.asarray(traj.x_man), np.asarray(traj.footholds)
    lines = ax.lines
    assert len(lines) == 2 + 2 * CFG.num_ee
    assert_line(lines[0], xs[:, 0], xs[:, 1], rtol=0)
    for e in range(CFG.num_ee):
        feet_line, marks = lines[1 + 2 * e], lines[2 + 2 * e]
        np.testing.assert_allclose(feet_line.get_xdata(), feet[:, e, 0],
                                   rtol=0, atol=1e-10)
        assert_line(feet_line, feet_line.get_xdata(), feet[:, e, 1])
        assert_line(marks, fh[e, :, 0], fh[e, :, 1], rtol=0)
    assert_line(lines[-1], qs[:, 0], qs[:, 1], rtol=0)
    boxes = [p for p in ax.patches]
    n_nodes = len(range(CFG.ee_node_start, xs.shape[0], 4))
    assert len(boxes) == n_nodes * CFG.num_ee
    hips = np.asarray(params.hip_offset)
    k0 = CFG.ee_node_start
    np.testing.assert_allclose(
        boxes[0].get_xy(), (xs[k0, 0] + hips[0, 0] - CFG.ee_box_size[0] / 2,
                            xs[k0, 1] + hips[0, 1] - CFG.ee_box_size[1] / 2),
        rtol=0, atol=1e-15)


def test_plan_of_two_robots_is_refused(plan):
    pt = tree_map(lambda a: torch.stack([a, a]), port_plan(plan[0], False))
    with pytest.raises(ValueError, match="one robot"):
        viz.plot_plan(pt, PCFG, path="never.png")
