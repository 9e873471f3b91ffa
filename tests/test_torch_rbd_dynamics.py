"""Port parity, float64: the Jacobians and the dynamics of the port's
``models/rbd.py`` against the JAX package, and the repaired per-call reads
of the model.

The JAX package differentiates forward kinematics (``jax.jacfwd``,
``jax.jvp``, ``jax.grad``); the port evaluates closed forms of the same
quantities.  Both are exact up to float64 rounding, so every result is held
to 1e-10 of its largest magnitude (the differences are ~1e-15 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.models import a1, rbd
from torch_jax_common import jit

torch.set_num_threads(2)

RTOL = 1e-10
OFFSET = np.array([0.013, -0.021, -0.107])


def _inputs(k=4, seed=7):
    """k configurations near the stand (unit quaternions, the first the
    stand itself) and generalized velocities (the last zero: gravity
    alone)."""
    rng = np.random.default_rng(seed)
    q = np.tile(ja1.stand_config().astype(np.float64), (k, 1))
    q += 0.15 * rng.standard_normal(q.shape)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    q[0] = ja1.stand_config()
    v = rng.standard_normal((k, 18)) * np.r_[[0.5] * 3, [1.0] * 3, [3.0] * 12]
    v[-1] = 0.0
    return q, v


def _jdot_v(model, q, v):
    """The JAX package's Jdot v (control/wbqp.py): the jvp of the feet's
    velocity along the configuration flow."""
    def foot_vel(dq):
        J = jrbd.ee_jacobians(model, jrbd.integrate_config(q, dq))
        return jnp.einsum('eiv,v->ei', J, v)
    return jax.jvp(foot_vel, (jnp.zeros(model.nv, q.dtype),), (v,))[1]


# name -> (JAX function of (model, q, v), port function of (model, q, v))
CASES = {
    "integrate_config": (lambda m, q, v: jrbd.integrate_config(q, 0.3 * v),
                         lambda m, q, v: rbd.integrate_config(q, 0.3 * v)),
    "velocity_to_qdot": (lambda m, q, v: jrbd.velocity_to_qdot(q, v),
                         lambda m, q, v: rbd.velocity_to_qdot(q, v)),
    "link_jacobians": (lambda m, q, v: jrbd.link_jacobians(m, q),
                       lambda m, q, v: rbd.link_jacobians(m, q)),
    "frame_jacobian": (
        lambda m, q, v: jrbd.frame_jacobian(m, q, 8, jnp.asarray(OFFSET)),
        lambda m, q, v: rbd.frame_jacobian(m, q, 8, torch.tensor(OFFSET))),
    "ee_jacobians": (lambda m, q, v: jrbd.ee_jacobians(m, q),
                     lambda m, q, v: rbd.ee_jacobians(m, q)),
    "mass_matrix": (lambda m, q, v: jrbd.mass_matrix(m, q),
                    lambda m, q, v: rbd.mass_matrix(m, q)),
    "kinetic_energy": (lambda m, q, v: jrbd.kinetic_energy(m, q, v),
                       lambda m, q, v: rbd.kinetic_energy(m, q, v)),
    "potential_energy": (lambda m, q, v: jrbd.potential_energy(m, q),
                         lambda m, q, v: rbd.potential_energy(m, q)),
    "bias_forces": (lambda m, q, v: jrbd.bias_forces(m, q, v),
                    lambda m, q, v: rbd.bias_forces(m, q, v)),
    "ee_bias_accelerations": (_jdot_v, rbd.ee_bias_accelerations),
}


def assert_close_rel(port, ref, rtol=RTOL):
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref)
        for p, r in zip(port, ref):
            assert_close_rel(p, r, rtol)
        return
    p, r = convert.to_numpy(port), np.asarray(ref)
    assert p.shape == r.shape
    np.testing.assert_allclose(p, r, rtol=0,
                               atol=rtol * max(np.abs(r).max(), 1e-300))


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    q, v = _inputs()
    jfn, pfn = CASES[name]
    jm = ja1.make_a1()
    ref = jit(jax.vmap(lambda qq, vv: jfn(jm, qq, vv)))(jnp.asarray(q),
                                                            jnp.asarray(v))
    got = pfn(a1.make_a1(device="cpu"), torch.tensor(q), torch.tensor(v))
    assert_close_rel(got, ref)


def test_bias_forces_are_the_lagrangian_identity_without_the_gyroscopic_term():
    """A single free body with its COM at the base origin: M is constant,
    so the reference's h has no omega x I omega on the base rows; the
    physical bias (Newton-Euler) has it, and the port subtracts it."""
    import dataclasses
    m = a1.make_a1(device="cpu")
    body = dataclasses.replace(
        m, parent=(0,), ee_link=(0,), hip_link=(0,), ee_names=("base",),
        joint_names=(), joint_trans=m.joint_trans[:1],
        joint_axis=m.joint_axis[:1], mass=m.mass[:1],
        com=torch.zeros(1, 3), inertia=m.inertia[:1], ee_offset=m.ee_offset[:1],
        joint_lower=m.joint_lower[:0], joint_upper=m.joint_upper[:0],
        effort_limit=m.effort_limit[:0], velocity_limit=m.velocity_limit[:0],
        total_mass=None)
    q = torch.tensor([[0.1, -0.2, 0.3, 0.1, 0.2, -0.3, 0.9]], dtype=torch.float64)
    q[:, 3:7] /= torch.linalg.vector_norm(q[:, 3:7], dim=-1, keepdim=True)
    v = torch.tensor([[0.3, -0.1, 0.2, 1.5, -2.0, 0.7]], dtype=torch.float64)
    h = rbd.bias_forces(body, q, v)
    weight = body.mass.double() * 9.81
    np.testing.assert_allclose(h.numpy(), [[0, 0, float(weight), 0, 0, 0]],
                               atol=1e-12)


def test_dynamics_terms_share_one_fk_bit_for_bit():
    """rbd.dynamics_terms (the whole-body QP's and the physics step's one
    pass) gives the bits of the functions it stands for."""
    q, v = (torch.tensor(a) for a in _inputs())
    m = a1.make_a1(device="cpu")
    M, h, J, feet, jdv = rbd.dynamics_terms(m, q, v)
    for got, want in ((M, rbd.mass_matrix(m, q)), (h, rbd.bias_forces(m, q, v)),
                      (J, rbd.ee_jacobians(m, q)),
                      (feet, rbd.ee_positions(m, q)),
                      (jdv, rbd.ee_bias_accelerations(m, q, v))):
        assert torch.equal(got, want)
    feet2, Jj = rbd.ee_joint_jacobians(m, q)
    assert torch.equal(feet2, feet) and torch.equal(Jj, J[..., 6:])


def test_link_selections_are_the_list_indexed_reads_bit_for_bit():
    """ee_positions and hip_positions select links through index tensors
    built once; the values are those of the Python-list reads they
    replace."""
    q = torch.tensor(_inputs()[0])
    m = a1.make_a1(device="cpu")
    Rs, ps = rbd.fk_links(m, q)
    links = list(m.ee_link)
    want = ps[..., links, :] + torch.einsum(
        '...eij,ej->...ei', Rs[..., links, :, :], m.ee_offset.to(q.dtype))
    assert torch.equal(rbd.ee_positions(m, q), want)
    assert torch.equal(rbd.hip_positions(m, q), ps[..., list(m.hip_link), :])
