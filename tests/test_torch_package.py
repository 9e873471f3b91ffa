"""The PyTorch port as a package: no JAX import, the JAX <-> port converter
round trip, and the float32 precision policy."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.models import a1 as ja1, rbd as jrbd, srb as jsrb
from bilevel_gait_gen_tpu.mpc import gait as jgait, qp as jqp
from bilevel_gait_gen_tpu.mpc import solver as jsolver
from bilevel_gait_gen_tpu.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu.ops import pdip as jpdip
from bilevel_gait_gen_tpu.utils.config import MPCConfig
from bilevel_gait_gen_tpu_torch import convert
from bilevel_gait_gen_tpu_torch.ops import kernels
from bilevel_gait_gen_tpu_torch.utils.precision import set_fp32_precision

torch.set_num_threads(2)

CFG = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                max_ls_iters=4, dt=0.05).validate()


@pytest.mark.parametrize("module", [
    "bilevel_gait_gen_tpu_torch",
    "bilevel_gait_gen_tpu_torch.mpc.bilevel",
    "bilevel_gait_gen_tpu_torch.problem",
    "chip_smoke",
])
def test_port_never_imports_jax(module):
    code = (f"import {module}, sys; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """Without CUDA (and, alone, without the package beside it) the smoke
    script exits non-zero and prints no result line."""
    import shutil
    from pathlib import Path
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _jax_state():
    model = ja1.make_a1()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    params = jsrb.make_srb_params(model, q0)
    x0 = jsrb.reconstruct_state(params, q0, jnp.zeros(model.nv))
    feet0 = jrbd.ee_positions(model, q0)
    traj = default_trajectory(CFG, jgait.make_trot(CFG), x0, feet0[:, :2])
    state = jsolver.make_state(CFG, traj,
                               jnp.asarray(CFG.ee_box_size, jnp.float64))
    return model, params, state, x0, feet0


def _assert_same(port_np, jax_obj, names):
    for name in names:
        np.testing.assert_array_equal(getattr(port_np, name),
                                      np.asarray(getattr(jax_obj, name)),
                                      err_msg=name)


def test_convert_round_trip():
    """Every converted object gives back the JAX arrays bit for bit."""
    model, params, state, x0, feet0 = _jax_state()
    m = convert.from_robot_model(model)
    assert m.parent == model.parent and m.ee_link == model.ee_link
    assert m.mass.dtype == torch.float32
    _assert_same(convert.to_numpy(m), model,
                 ["joint_trans", "joint_axis", "mass", "com", "inertia",
                  "ee_offset", "joint_lower", "joint_upper"])
    _assert_same(convert.to_numpy(convert.from_srb_params(params)), params,
                 ["mass", "inertia", "inertia_inv", "hip_offset",
                  "com_offset", "hip_offset_raw"])
    st = convert.from_solver_state(state)
    st_np = convert.to_numpy(st)
    _assert_same(st_np.traj, state.traj, ["x_man", "f_nodes", "footholds"])
    _assert_same(st_np.traj.sched, state.traj.sched, ["bounds"])
    _assert_same(st_np.qp_warm, state.qp_warm,
                 ["x", "y", "lam", "s", "iters", "gap", "pri_res", "dua_res"])
    assert st.qp_warm.iters.dtype == torch.int32
    assert np.isinf(st_np.qp_warm.gap)

    x_des = jsrb.manifold_to_tangent(x0)
    qp = jqp.assemble(CFG, params, state.traj, x0, jnp.asarray(0.0), feet0,
                      x_des, state.ee_box)
    _assert_same(convert.to_numpy(convert.from_condensed_qp(qp)), qp,
                 ["H", "q", "A", "b", "G", "h", "S", "c", "cost_const"])
    sol = jpdip.solve(qp.H, qp.q, qp.A, qp.b, qp.G, qp.h, iters=3)
    _assert_same(convert.to_numpy(convert.from_qp_solution(sol)), sol,
                 ["x", "y", "lam", "s", "iters", "gap", "pri_res", "dua_res"])


def test_convert_float32_on_request():
    _, params, state, _, _ = _jax_state()
    st = convert.from_solver_state(state, dtype=torch.float32)
    assert st.traj.x_man.dtype == torch.float32
    assert st.qp_warm.iters.dtype == torch.int32
    p = convert.from_srb_params(params, dtype=torch.float32)
    assert p.inertia.dtype == torch.float32


def test_tf32_is_off_after_precision_call():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        set_fp32_precision()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        set_fp32_precision()


def test_precision_call_rejects_reduced_matmul_precision():
    """Reduced precision raises, whether from the check itself or from
    PyTorch's own refusal of mixed precision settings."""
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError):
            set_fp32_precision()
    finally:
        torch.set_float32_matmul_precision("highest")
        set_fp32_precision()


def test_kernel_sources_are_hashed_and_nothing_is_built_on_import():
    """The build key covers every source; importing built nothing."""
    assert len(kernels.source_hash()) == 16
    assert kernels._lib is None
    for name in ("common.cuh", "gtwg.cu", "ipm_iter.cu"):
        assert (kernels.CSRC / name).is_file()
