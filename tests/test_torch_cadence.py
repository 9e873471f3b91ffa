"""The bench cadence's loops (``mpc/cadence.py``) and their CUDA graphs
(``utils/graphs.py``).

On the CPU: the loops equal the hand-written loops of ``solve_step`` and
``gait_opt_update`` bit for bit and leave their inputs as they were (a
graph reads its inputs from static buffers), so that the JAX parity of
those loops (tests/test_torch_bilevel.py) is theirs; the per-call path
makes no tensor from host data and reads nothing back (the CPU's stand-in
for "a CUDA graph capture sees no host copy"); ``Graphed`` refuses CPU
tensors; ``make_problem(push_vx=)`` is bench.py's push, held to the JAX
package.  On the card
(``cuda``-marked, skipped here): a replayed cycle and RTI block give the
eager bits, and the capture counts the kernels' launches.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, srb as jsrb
from bilevel_gait_gen_tpu_torch import convert, problem
from bilevel_gait_gen_tpu_torch.mpc import bilevel, cadence, solver
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch.utils.graphs import (Graphed, copy_into,
                                                     tree_leaves, tree_map)

torch.set_num_threads(2)

# the small configuration of tests/test_torch_bilevel.py
CFG = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                max_ls_iters=4, dt=0.05, ipm_grad_polish=2,
                ls_ipm_iters=16).validate()
# bench.py's configuration, for the guard and the graphs
BENCH = MPCConfig(ipm_iters=10, ipm_exact_every=5, ipm_grad_polish=2,
                  qp_kernel="xla").validate()
B, FREQ, STRETCH = 2, 3, 1.3


BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def assert_bitwise(a, b):
    """The same tensors bit for bit (NaNs included)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        as_bits = BITS.get(x.dtype, x.dtype)
        assert torch.equal(x.view(as_bits), y.view(as_bits))


def clone(tree):
    return tree_map(torch.clone, tree)


@pytest.fixture(scope="module")
def pr64():
    return problem.make_problem(CFG, B, dtype=torch.float64, stretch=STRETCH,
                                device="cpu")


def test_cycle_is_the_hand_written_loop_and_keeps_its_inputs(pr64):
    before = clone(pr64.loop_args())
    st, solved, gres, frac = cadence.cycle(CFG, pr64.params, *pr64.loop_args(),
                                           FREQ)
    assert_bitwise(pr64.loop_args(), before)
    s, flags = pr64.states, []
    for _ in range(FREQ - 1):
        s, stats = solver.solve_step(CFG, pr64.params, s, pr64.x0s, pr64.t0,
                                     pr64.feets, pr64.x_des)
        flags.append(stats.solved)
    ref = bilevel.gait_opt_update(CFG, pr64.params, s, pr64.x0s, pr64.t0,
                                  pr64.feets, pr64.x_des)
    assert_bitwise((st, solved, gres), (ref.state, torch.stack(flags), ref))
    want = (torch.stack(flags).float().mean() * (FREQ - 1) / FREQ
            + ref.rti_stats.solved.float().mean() / FREQ)
    assert frac.dtype == torch.float32 and torch.equal(frac, want)


@pytest.mark.parametrize("batch", [B, 1])
def test_rti_block_and_chain_are_the_hand_written_loop(pr64, batch):
    """rti_block over the batch, and at batch 1 (bench.py's chain)."""
    pr = dataclasses.replace(
        pr64, states=tree_map(lambda t: t[:batch], pr64.states),
        x0s=pr64.x0s[:batch], t0=pr64.t0[:batch], feets=pr64.feets[:batch],
        x_des=pr64.x_des[:batch])
    st, costs, solved = cadence.rti_block(CFG, pr.params, *pr.loop_args(), 3)
    s, c_ref, f_ref = pr.states, [], []
    for _ in range(3):
        s, stats = solver.solve_step(CFG, pr.params, s, *pr.loop_args()[1:])
        c_ref.append(stats.cost)
        f_ref.append(stats.solved)
    assert costs.shape == solved.shape == (3, batch)
    assert_bitwise((st, costs, solved),
                   (s, torch.stack(c_ref), torch.stack(f_ref)))


def test_gait_chain_carries_state_and_trust(pr64):
    trust = torch.full((B,), 0.7, dtype=torch.float64)
    st, tr, costs, acc = cadence.gait_chain(CFG, pr64.params, pr64.states,
                                            trust, *pr64.loop_args()[1:], 2)
    s, t, c_ref, a_ref = pr64.states, trust, [], []
    for _ in range(2):
        r = bilevel.gait_opt_update(CFG, pr64.params, s, *pr64.loop_args()[1:],
                                    trust=t)
        s, t = r.state, r.trust
        c_ref.append(r.cost)
        a_ref.append(r.accepted)
    assert_bitwise((st, tr, costs, acc),
                   (s, t, torch.stack(c_ref), torch.stack(a_ref)))


# ---------------------------------------------------------------------------
# the host-copy guard
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def warm(request):
    """The bench problem at batch 2 and a state after one warm cycle (the
    first call builds the constants that every later call shares)."""
    pr = problem.make_problem(BENCH, B, dtype=request.param, device="cpu")
    st = cadence.cycle(BENCH, pr.params, *pr.loop_args(), 2)[0]
    return pr, st


def _refuse(what):
    def refused(*args, **kw):
        raise AssertionError(f"{what} on the per-call path")
    return refused


@pytest.fixture
def no_host_data(monkeypatch):
    """Every way the port's code could make a tensor from host data (a
    list index among them), or read a tensor back to the host, raises."""
    as_tensor = torch.as_tensor

    def as_tensor_of_tensor(data, *args, **kw):
        if not isinstance(data, torch.Tensor):
            raise AssertionError("torch.as_tensor of host data on the "
                                 "per-call path")
        return as_tensor(data, *args, **kw)

    setitem = torch.Tensor.__setitem__

    def setitem_of_host_number(self, index, value):
        # a number written through tensor indices (index_put_), or into one
        # element, is a copy from the host on the card
        parts = index if isinstance(index, tuple) else (index,)
        if not isinstance(value, torch.Tensor) and (
                any(isinstance(i, (torch.Tensor, list)) for i in parts)
                or self[index].dim() == 0):
            raise AssertionError("a number written through tensor indices "
                                 "on the per-call path")
        return setitem(self, index, value)

    getitem = torch.Tensor.__getitem__

    def getitem_of_host_list(self, index):
        # a read through a Python list of indices builds the index tensor on
        # the host and copies it over on the card
        parts = index if isinstance(index, tuple) else (index,)
        if any(isinstance(i, list) for i in parts):
            raise AssertionError("a read through a list index on the "
                                 "per-call path")
        return getitem(self, index)

    monkeypatch.setattr(torch.Tensor, "__setitem__", setitem_of_host_number)
    monkeypatch.setattr(torch.Tensor, "__getitem__", getitem_of_host_list)
    monkeypatch.setattr(torch, "tensor", _refuse("torch.tensor"))
    monkeypatch.setattr(torch, "as_tensor", as_tensor_of_tensor)
    monkeypatch.setattr(torch, "from_numpy", _refuse("torch.from_numpy"))
    for name in ("item", "tolist", "numpy", "__bool__", "__float__",
                 "__int__"):
        monkeypatch.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))


@pytest.fixture(scope="module")
def centroidal_warm(warm):
    """The centroidal RTI on the bench problem's scenarios (the A1 at its
    stand), after one step that builds the constants; the ADMM backend's
    configuration after one step of it."""
    from bilevel_gait_gen_tpu_torch.models import a1
    from bilevel_gait_gen_tpu_torch.mpc import centroidal
    pr, st = warm
    dtype = pr.x0s.dtype
    model = a1.make_a1(device="cpu")
    q0 = torch.tensor(a1.stand_config(), dtype=dtype).expand(B, -1)
    cst = centroidal.make_centroidal_state(BENCH, model, st.traj, st.ee_box,
                                           q0)
    cst = centroidal.solve_centroidal_step(BENCH, model, pr.params, cst,
                                           *pr.loop_args()[1:])[0]
    admm_cfg = dataclasses.replace(BENCH, qp_backend="admm", admm_iters=40)
    ast = solver.solve_step(admm_cfg, pr.params, st, *pr.loop_args()[1:])[0]
    return model, cst, admm_cfg, ast


@pytest.mark.parametrize("entry", ["solve_step", "gait_opt_update", "cycle",
                                   "solve_centroidal_step",
                                   "solve_step_admm"])
def test_per_call_path_copies_nothing_from_the_host(warm, centroidal_warm,
                                                    no_host_data, entry):
    pr, st = warm
    rest = pr.loop_args()[1:]
    if entry == "solve_step":
        solver.solve_step(BENCH, pr.params, st, *rest)
    elif entry == "gait_opt_update":
        bilevel.gait_opt_update(BENCH, pr.params, st, *rest)
    elif entry == "solve_centroidal_step":
        from bilevel_gait_gen_tpu_torch.mpc import centroidal
        model, cst = centroidal_warm[:2]
        centroidal.solve_centroidal_step(BENCH, model, pr.params, cst, *rest)
    elif entry == "solve_step_admm":
        admm_cfg, ast = centroidal_warm[2:]
        solver.solve_step(admm_cfg, pr.params, ast, *rest)
    else:
        cadence.cycle(BENCH, pr.params, st, *rest, 2)


def test_the_guard_catches_a_host_copy(warm, no_host_data):
    with pytest.raises(AssertionError, match="torch.tensor"):
        torch.tensor([1.0])
    with pytest.raises(AssertionError, match="__float__"):
        float(warm[0].x0s[0, 0])
    t = torch.zeros(3)
    with pytest.raises(AssertionError, match="tensor indices"):
        t[torch.arange(2)] = 1.0
    with pytest.raises(AssertionError, match="tensor indices"):
        t[0] = 1.0
    t[1:] = 1.0
    with pytest.raises(AssertionError, match="list index"):
        t[[0, 2]]
    with pytest.raises(AssertionError, match="list index"):
        torch.zeros(2, 3)[..., [0, 2]]
    t[torch.arange(2)]


# ---------------------------------------------------------------------------
# Graphed and its trees
# ---------------------------------------------------------------------------

def test_graphed_refuses_cpu_tensors(pr64):
    with pytest.raises(ValueError, match="lies on cpu"):
        Graphed(lambda st: st, pr64.states)
    with pytest.raises(ValueError, match="at least one tensor"):
        Graphed(lambda: None)


def test_tree_map_and_copy_into_keep_the_structure(pr64):
    st = pr64.states
    doubled = tree_map(lambda t: 2 * t, st)
    assert type(doubled) is type(st) and doubled.qp_warm.iters.dtype == \
        torch.int32
    dst = clone(st)
    copy_into(dst, doubled)
    assert_bitwise(dst, doubled)
    with pytest.raises(ValueError, match="static buffers"):
        copy_into(dst, dataclasses.replace(st, qp_warm=None))
    with pytest.raises(ValueError, match="shape"):
        copy_into(dst.ee_box, st.ee_box[:1])


def test_make_problem_push_matches_bench_py():
    """bench.py's make_problem(push_vx=): x0[3] = mass * push_vx, in the
    measured states and in the trajectory's initial guess."""
    cfg = MPCConfig().validate()
    model = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    params = jsrb.make_srb_params(model, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(model.nv))
    x0 = x0.at[3].set(params.mass * 0.3)
    pr = problem.make_problem(cfg, 3, dtype=torch.float64, device="cpu",
                              push_vx=0.3)
    np.testing.assert_allclose(pr.states.traj.x_man[:, 0].numpy(),
                               np.tile(np.asarray(x0), (3, 1)), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(
        pr.x0s.numpy(), np.asarray(x0)[None] + problem.perturbations(3),
        rtol=1e-12, atol=1e-14)
    still = problem.make_problem(cfg, 3, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(pr.x_des.numpy(), still.x_des.numpy())
    np.testing.assert_allclose(convert.to_numpy(pr.x0s[:, 3]
                                                - still.x0s[:, 3]),
                               float(params.mass) * 0.3, rtol=1e-12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["cycle", "rti_block"])
def test_replay_gives_the_eager_bits(card, loop):
    from bilevel_gait_gen_tpu_torch.ops import kernels
    pr = problem.make_problem(BENCH, 8, device=card)
    st = cadence.rti_block(BENCH, pr.params, *pr.loop_args(), 2)[0]
    fn = {"cycle": lambda *a: cadence.cycle(BENCH, pr.params, *a, 10),
          "rti_block": lambda *a: cadence.rti_block(BENCH, pr.params, *a,
                                                    10)}[loop]
    g = Graphed(fn, st, *pr.loop_args()[1:], carry={0: lambda out: out[0]})
    want = fn(st, *pr.loop_args()[1:])
    got = g()
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    if loop == "cycle":
        n = BENCH.ls_ipm_iters + BENCH.ipm_grad_polish
        caught = dict(g.captured_launches)
        # kernels.bmv: srb._mv's shared inertia in every assembly
        assert caught.pop("bmv") > 0
        assert caught == {"gtwg": n, "ipm_iter": n, "gj_inverse": 0,
                          "rgemm": 0, "chol_inverse": 0}
        before = kernels.launch_counts()
        g()
        assert kernels.launch_counts() == before
        assert g.replayed_launches()["ipm_iter"] == 2 * n
    # the carried state: the next replay starts where this one ended
    assert_bitwise(g.args[0], want[0])
