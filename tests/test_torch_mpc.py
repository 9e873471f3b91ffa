"""Port parity, float64, of the MPC building blocks: splines, gait
schedules, trajectories and the condensed QP (with its gradient with
respect to the contact times) against the JAX package.

Tolerances: rtol 1e-10 for the splines, schedules and trajectories (same
formulas; a few sums in another order cost ~1e-15).  The QP is held to
rtol 1e-9 on the scale of its largest entry: the condensing loop multiplies
twenty 12x12 node maps, and entries span ~12 decades (H reaches ~1e8), so
entrywise relative error means nothing for the entries near zero.  Its
gradient with respect to the bounds: rtol 1e-7 of its largest entry;
measured ~1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait, qp as jqp
from bilevel_gait_gen_tpu.mpc.gait import GaitSchedule as JSched
from bilevel_gait_gen_tpu.mpc.trajectory import (Trajectory as JTraj,
                                                 default_trajectory as jdeft,
                                                 make_unravel as jmake_unravel,
                                                 ravel_u as jravel_u)
from bilevel_gait_gen_tpu.ops import spline as jspline
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
from bilevel_gait_gen_tpu_torch.mpc import gait, qp
from bilevel_gait_gen_tpu_torch.mpc.trajectory import (default_trajectory,
                                                       make_unravel, ravel_u)
from bilevel_gait_gen_tpu_torch.ops import spline

torch.set_num_threads(2)

F64 = torch.float64
CFG = MPCConfig().validate()          # N=20, dt=0.05: the bench problem


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(port, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(convert.to_numpy(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _bounds(seed=0, stretch=1.0):
    """Trot bounds with a jitter, plus rows with exact ties and a
    zero-length swing (standing)."""
    b = np.asarray(jgait.make_trot(CFG).bounds) * stretch
    rng = np.random.default_rng(seed)
    b = b + np.cumsum(0.02 * np.abs(rng.standard_normal(b.shape)), axis=-1)
    stand = np.asarray(jgait.make_standing(CFG).bounds)
    return np.concatenate([b, np.asarray(jgait.make_trot(CFG).bounds),
                           stand[:1]])


TIMES = np.array([-0.7, -0.3, 0.0, 0.1, 0.3, 0.3333, 0.6, 0.9, 1.2, 2.5,
                  9.0])


def _per_row_and_time(fn_j, rows, times):
    """JAX reference over rows x times -> [R, T, ...]."""
    return jax.vmap(lambda r: jax.vmap(lambda tt: fn_j(r, tt))(
        jnp.asarray(times)))(jnp.asarray(rows))


@pytest.mark.parametrize("name", ["force_weights", "foothold_weights",
                                  "foot_z_value", "phase_index",
                                  "next_touchdown_time",
                                  "current_swing_time"])
def test_schedule_queries_and_weights(name):
    rows = _bounds()
    mod_j = jspline if hasattr(jspline, name) and name not in (
        "phase_index",) else jgait
    mod_t = spline if mod_j is jspline else gait
    extra = {"force_weights": (CFG.num_force_polys,),
             "foot_z_value": (CFG.swing_height, CFG.foot_offset)}.get(name, ())
    ref = _per_row_and_time(lambda r, tt: getattr(mod_j, name)(r, tt, *extra),
                            rows, TIMES)
    got = getattr(mod_t, name)(t(rows)[:, None], t(TIMES)[None, :], *extra)
    close(got, ref)


def test_force_value_and_foot_position():
    rows = _bounds(1)
    rng = np.random.default_rng(2)
    S = CFG.num_stance_slots
    fn = rng.standard_normal((rows.shape[0], S, CFG.num_force_polys - 1, 3, 2))
    fh = rng.standard_normal((rows.shape[0], S + 1, 2))
    ref = jax.vmap(lambda r, f: jax.vmap(lambda tt: jspline.force_value(
        r, f, tt, CFG.num_force_polys))(jnp.asarray(TIMES)))(
        jnp.asarray(rows), jnp.asarray(fn))
    got = spline.force_value(t(rows)[:, None], t(fn)[:, None],
                             t(TIMES)[None, :], CFG.num_force_polys)
    close(got, ref)
    ref = jax.vmap(lambda r, f: jax.vmap(lambda tt: jspline.foot_position(
        r, f, tt, CFG.swing_height, CFG.foot_offset))(jnp.asarray(TIMES)))(
        jnp.asarray(rows), jnp.asarray(fh))
    got = spline.foot_position(t(rows)[:, None], t(fh)[:, None],
                               t(TIMES)[None, :], CFG.swing_height,
                               CFG.foot_offset)
    close(got, ref)


def test_carrier_weights_and_all_ee_helpers():
    b = _bounds(3)[:4]
    ref = jax.vmap(lambda tt: jspline.carrier_weights(jnp.asarray(b), tt,
                                                      CFG.carrier_ramp))(
        jnp.asarray(TIMES))
    close(spline.carrier_weights(t(b), t(TIMES), CFG.carrier_ramp), ref)
    fh = np.random.default_rng(4).standard_normal((4, CFG.num_footholds, 2))
    ref = jax.vmap(lambda tt: jspline.foot_positions_all(
        jnp.asarray(b), jnp.asarray(fh), tt, CFG.swing_height,
        CFG.foot_offset))(jnp.asarray(TIMES))
    close(spline.foot_positions_all(t(b), t(fh), t(TIMES), CFG.swing_height,
                                    CFG.foot_offset), ref)


def test_spline_gradients_wrt_bounds_match_jax_at_ties():
    """d(weights)/d(bounds) where sample times sit exactly on boundaries:
    jnp.clip/maximum split the cotangent at ties, and so must the port."""
    row = np.asarray(jgait.make_trot(CFG).bounds)[1]
    times = np.array([0.0, 0.3, 0.6, 0.45, 1.2])

    def jfn(r):
        w = jax.vmap(lambda tt: jnp.sum(
            jspline.force_weights(r, tt, 3) ** 2)
            + jnp.sum(jspline.foothold_weights(r, tt) ** 2)
            + jspline.foot_z_value(r, tt, 0.075, 0.015))(jnp.asarray(times))
        return jnp.sum(w)

    gj = jax.grad(jfn)(jnp.asarray(row))
    r = t(row).requires_grad_(True)
    tt = t(times)
    v = (torch.sum(spline.force_weights(r, tt, 3) ** 2)
         + torch.sum(spline.foothold_weights(r, tt) ** 2)
         + torch.sum(spline.foot_z_value(r, tt, 0.075, 0.015)))
    (g,) = torch.autograd.grad(v, r)
    close(g, gj, atol=1e-10)


def test_make_trot_window_shift_and_rolls():
    for cfg in (CFG, MPCConfig(double_support=0.05).validate()):
        close(gait.make_trot(cfg, dtype=F64).bounds, jgait.make_trot(cfg).bounds)
    b = _bounds(5)[:4]
    rng = np.random.default_rng(6)
    S = CFG.num_stance_slots
    fn = rng.standard_normal((4, S, CFG.num_force_polys - 1, 3, 2))
    fh = rng.standard_normal((4, S + 1, 2))
    for t0 in (0.0, 0.35, 0.61, 1.3):
        js = JSched(bounds=jnp.asarray(b))
        t0j = jnp.asarray(t0)
        ts = gait.GaitSchedule(bounds=t(b))
        t0t = t(t0)
        close(gait.advance_window(ts, t0t, CFG).bounds,
              jgait.advance_window(js, t0j, CFG).bounds)
        n_past = jgait.past_cycles(js, t0j)
        np.testing.assert_array_equal(gait.past_cycles(ts, t0t).numpy(),
                                      np.asarray(n_past))
        rf, rh = gait.roll_spline_vars(t(fn), t(fh),
                                       torch.tensor(np.asarray(n_past)))
        jf, jh = jgait.roll_spline_vars(jnp.asarray(fn), jnp.asarray(fh),
                                        n_past)
        close(rf, jf)
        close(rh, jh)
        np.testing.assert_array_equal(
            gait.contact_flags(ts, t0t).numpy(),
            np.asarray(jgait.contact_flags(js, t0j)))


def _jax_problem(stretch=1.0):
    model = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    params = jsrb.make_srb_params(model, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(model.nv))
    feet0 = jrbd.ee_positions(model, q0)
    sched = jgait.make_trot(CFG)
    sched = JSched(bounds=sched.bounds * stretch)
    traj = jdeft(CFG, sched, x0, feet0[:, :2])
    return params, x0, feet0, traj


def test_default_trajectory_and_ravel():
    params, x0, feet0, traj = _jax_problem()
    model = a1.make_a1()
    q0 = t(a1.stand_config())
    x0_t = srb.reconstruct_state(srb.make_srb_params(model, q0), q0,
                                 torch.zeros(model.nv, dtype=F64))
    feet_t = rbd.ee_positions(model, q0)
    tr = default_trajectory(CFG, gait.make_trot(CFG, dtype=F64), x0_t[None],
                            feet_t[None, :, :2])
    close(tr.x_man[0], traj.x_man)
    close(tr.f_nodes[0], traj.f_nodes)
    close(tr.footholds[0], traj.footholds)
    close(tr.sched.bounds[0], traj.sched.bounds)
    u = np.random.default_rng(7).standard_normal(CFG.num_u)
    jf, jh = jmake_unravel(CFG)(jnp.asarray(u))
    f, h = make_unravel(CFG)(t(u)[None])
    close(f[0], jf)
    close(h[0], jh)
    close(ravel_u(f, h)[0], jravel_u(jf, jh))


def _perturbed(traj, seed):
    rng = np.random.default_rng(seed)
    return JTraj(
        x_man=traj.x_man + 0.01 * rng.standard_normal(traj.x_man.shape),
        f_nodes=traj.f_nodes + rng.standard_normal(traj.f_nodes.shape),
        footholds=traj.footholds + 0.02 * rng.standard_normal(
            traj.footholds.shape),
        sched=traj.sched)


def _assemble_pair(cfg, traj, params, x0, feet0, t0, box=None):
    box = jnp.asarray(cfg.ee_box_size if box is None else box, jnp.float64)
    x_des = jsrb.manifold_to_tangent(x0)
    ref = jqp.assemble(cfg, params, traj, x0, jnp.asarray(t0), feet0, x_des,
                       box)
    b1 = jax.tree.map(lambda a: a[None], (traj, x0, feet0, x_des, box))
    tr, x0_t, feet_t, xd_t, box_t = b1
    got = qp.assemble(cfg, convert.from_srb_params(params),
                      convert.from_trajectory(tr), t(x0_t),
                      t([t0]), t(feet_t), t(xd_t), t(box_t))
    return got, ref


def _close_scaled(got, ref, rtol=1e-9):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(convert.to_numpy(got), ref, rtol=0,
                               atol=rtol * scale)


@pytest.mark.parametrize("case", ["initial", "perturbed", "shifted",
                                  "stretched_box", "carrier", "rk2"])
def test_assemble_matches_jax(case):
    cfg = {"carrier": MPCConfig(force_carrier=True).validate(),
           "rk2": MPCConfig(integrator="rk2").validate()}.get(case, CFG)
    params, x0, feet0, traj = _jax_problem(
        stretch=1.2 if case == "stretched_box" else 1.0)
    if case != "initial":
        traj = _perturbed(traj, 8)
    t0 = 0.17 if case == "shifted" else 0.0
    box = (0.2, 0.12) if case == "stretched_box" else None
    got, ref = _assemble_pair(cfg, traj, params, x0, feet0, t0, box)
    for name in ("H", "q", "A", "b", "G", "h", "S", "c"):
        _close_scaled(getattr(got, name)[0], getattr(ref, name))
    _close_scaled(got.cost_const[0], ref.cost_const)


def test_assemble_gradient_wrt_bounds_matches_jax():
    """d/d(bounds) of a scalar of the assembled QP at a fixed u, through
    every differentiable path of assemble (the test_qp_fast contract)."""
    params, x0, feet0, traj = _jax_problem()
    traj = _perturbed(traj, 9)
    x_des = jsrb.manifold_to_tangent(x0)
    box = jnp.asarray(CFG.ee_box_size, jnp.float64)
    u = np.random.default_rng(10).standard_normal(CFG.num_u)
    t0 = 0.17

    def jobj(bounds):
        tr = JTraj(x_man=traj.x_man, f_nodes=traj.f_nodes,
                   footholds=traj.footholds, sched=JSched(bounds=bounds))
        q_ = jqp.assemble(CFG, params, tr, x0, jnp.asarray(t0), feet0, x_des,
                          box)
        uu = jnp.asarray(u)
        return (0.5 * uu @ q_.H @ uu + q_.q @ uu + jnp.sum(q_.G @ uu - q_.h)
                + jnp.sum(q_.A @ uu - q_.b) + q_.cost_const)

    gj = jax.grad(jobj)(traj.sched.bounds)
    tr_t = convert.from_trajectory(jax.tree.map(lambda a: a[None], traj))
    bounds = tr_t.sched.bounds.clone().requires_grad_(True)
    tr_t = type(tr_t)(x_man=tr_t.x_man, f_nodes=tr_t.f_nodes,
                      footholds=tr_t.footholds,
                      sched=gait.GaitSchedule(bounds=bounds))
    q_ = qp.assemble(CFG, convert.from_srb_params(params), tr_t,
                     t(x0)[None], t([t0]), t(feet0)[None], t(x_des)[None],
                     t(box)[None])
    uu = t(u)[None]
    val = (0.5 * torch.einsum('bi,bij,bj->b', uu, q_.H, uu)
           + torch.sum(q_.q * uu, -1)
           + torch.sum(torch.einsum('bmi,bi->bm', q_.G, uu) - q_.h, -1)
           + torch.sum(torch.einsum('bpi,bi->bp', q_.A, uu) - q_.b, -1)
           + q_.cost_const)
    (g,) = torch.autograd.grad(val.sum(), bounds)
    gj = np.asarray(gj)
    np.testing.assert_allclose(g[0].numpy(), gj, rtol=1e-7,
                               atol=1e-7 * np.abs(gj).max())


def test_recover_states_and_cost_value():
    params, x0, feet0, traj = _jax_problem()
    got, ref = _assemble_pair(CFG, _perturbed(traj, 11), params, x0, feet0,
                              0.0)
    u = np.random.default_rng(12).standard_normal(CFG.num_u)
    xs_j = jqp.recover_states(ref, jnp.asarray(u))
    xs = qp.recover_states(got, t(u)[None])
    _close_scaled(xs[0], xs_j)
    x_des = jsrb.manifold_to_tangent(x0)
    cj = jqp.cost_value(CFG, xs_j, jnp.asarray(u), x_des)
    c = qp.cost_value(CFG, xs, t(u)[None], t(x_des)[None])
    close(c[0], cj, rtol=1e-9)
