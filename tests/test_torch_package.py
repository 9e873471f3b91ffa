"""The PyTorch port as a package: no JAX import, the JAX <-> port converter
round trip, and the float32 precision policy."""
import dataclasses
import subprocess
import sys
from pathlib import Path

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
from test_torch_demos import script

torch.set_num_threads(2)

CFG = MPCConfig(num_nodes=6, num_phase_slots=4, phase_duration=0.5,
                samples_per_stance=4, ee_node_start=1, ipm_iters=8,
                max_ls_iters=4, dt=0.05).validate()


@pytest.mark.parametrize("module", [
    "bilevel_gait_gen_tpu_torch",
    "bilevel_gait_gen_tpu_torch.mpc.bilevel",
    "bilevel_gait_gen_tpu_torch.problem",
    "bilevel_gait_gen_tpu_torch.mpc.cadence",
    "bilevel_gait_gen_tpu_torch.utils.graphs",
    "bilevel_gait_gen_tpu_torch.ops.kernel_checks",
    "bilevel_gait_gen_tpu_torch.control.ik",
    "bilevel_gait_gen_tpu_torch.control.wbqp",
    "bilevel_gait_gen_tpu_torch.control.mpc_controller",
    "bilevel_gait_gen_tpu_torch.sim.engine",
    "bilevel_gait_gen_tpu_torch.mpc.centroidal",
    "bilevel_gait_gen_tpu_torch.ops.admm",
    "bilevel_gait_gen_tpu_torch.models.adam",
    "bilevel_gait_gen_tpu_torch.models.mini_cheetah",
    "bilevel_gait_gen_tpu_torch.models.urdf",
    "bilevel_gait_gen_tpu_torch.utils.config",
    "bilevel_gait_gen_tpu_torch.runtime",
    "bilevel_gait_gen_tpu_torch.control.unitree_wire",
    "bilevel_gait_gen_tpu_torch.control.hardware",
    "bilevel_gait_gen_tpu_torch.utils.lowlevel_log",
    "bilevel_gait_gen_tpu_torch.utils.stats",
    "bilevel_gait_gen_tpu_torch.utils.timing",
    "bilevel_gait_gen_tpu_torch.utils.checkpoint",
    "bilevel_gait_gen_tpu_torch.sim.viz",
    "bilevel_gait_gen_tpu_torch.parallel.mesh",
    "bilevel_gait_gen_tpu_torch.parallel.multihost",
    "bilevel_gait_gen_tpu_torch.utils.collectives",
    "chip_smoke",
    "bench_torch",
])
def test_port_never_imports_jax(module):
    """Importing the port loads neither jax nor the JAX package."""
    code = (f"import {module}, sys; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bilevel_gait_gen_tpu')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_solver_layer_loads_no_mesh_code():
    """``mpc.bilevel`` gathers its lanes through ``utils.collectives``: it
    loads neither ``parallel/`` nor the DTensor modules."""
    code = ("import bilevel_gait_gen_tpu_torch.mpc.bilevel, sys; "
            "bad = sorted(m for m in sys.modules if m.startswith(("
            "'bilevel_gait_gen_tpu_torch.parallel', "
            "'torch.distributed.tensor'))); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_demo_scripts_never_import_jax():
    """Importing every scripts/torch_*.py (their ``main`` is not run)
    loads neither jax nor the JAX package."""
    code = ("import importlib.util, pathlib, sys\n"
            "for p in sorted(pathlib.Path('scripts').glob('torch_*.py')):\n"
            "    spec = importlib.util.spec_from_file_location(p.stem, p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bilevel_gait_gen_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)


def _port_sources():
    root = Path(__file__).resolve().parent.parent
    return (sorted((root / "bilevel_gait_gen_tpu_torch").rglob("*.py"))
            + sorted((root / "scripts").glob("torch_*.py"))
            + [root / "chip_smoke.py", root / "bench_torch.py"])


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(p.parents[1]))
                         if p.name not in ("chip_smoke.py", "bench_torch.py")
                         else p.name)
def test_port_source_names_no_jax_import(path):
    """No import statement of any port source (function-level ones
    included) names jax or the JAX package; the package name followed by
    ``_torch`` is the port's own."""
    import ast
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "bilevel_gait_gen_tpu"), (path.name, name)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """Without CUDA (and, alone, without the package beside it) the smoke
    script exits non-zero and prints no result line."""
    import shutil
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
    m = convert.from_robot_model(model, device="cpu")
    assert m.parent == model.parent and m.ee_link == model.ee_link
    assert m.mass.dtype == torch.float32
    _assert_same(convert.to_numpy(m), model,
                 ["joint_trans", "joint_axis", "mass", "com", "inertia",
                  "ee_offset", "joint_lower", "joint_upper"])
    _assert_same(convert.to_numpy(convert.from_srb_params(params, device="cpu")), params,
                 ["mass", "inertia", "inertia_inv", "hip_offset",
                  "com_offset", "hip_offset_raw"])
    st = convert.from_solver_state(state, device="cpu")
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
    _assert_same(convert.to_numpy(convert.from_condensed_qp(qp, device="cpu")), qp,
                 ["H", "q", "A", "b", "G", "h", "S", "c", "cost_const"])
    sol = jpdip.solve(qp.H, qp.q, qp.A, qp.b, qp.G, qp.h, iters=3)
    _assert_same(convert.to_numpy(convert.from_qp_solution(sol, device="cpu")), sol,
                 ["x", "y", "lam", "s", "iters", "gap", "pri_res", "dua_res"])


def test_convert_float32_on_request():
    _, params, state, _, _ = _jax_state()
    st = convert.from_solver_state(state, dtype=torch.float32, device="cpu")
    assert st.traj.x_man.dtype == torch.float32
    assert st.qp_warm.iters.dtype == torch.int32
    p = convert.from_srb_params(params, dtype=torch.float32, device="cpu")
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
    for name in ("common.cuh", "gtwg.cu", "ipm_iter.cu", "gj_inverse.cu"):
        assert (kernels.CSRC / name).is_file()
        assert name in kernels._SOURCES


# ---------------------------------------------------------------------------
# the port's own MPCConfig and the device default
# ---------------------------------------------------------------------------

def test_config_copy_has_the_same_fields_defaults_and_properties():
    """The port's MPCConfig cannot drift from the JAX package's unnoticed:
    same field names in the same order, same defaults, same derived
    properties, the same validate() verdicts."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig as PortCfg
    jf, pf = dataclasses.fields(MPCConfig), dataclasses.fields(PortCfg)
    assert [f.name for f in pf] == [f.name for f in jf]
    for a, b in zip(pf, jf):
        assert a.default == b.default, a.name
    for kw in ({}, dict(num_nodes=6, num_phase_slots=4, phase_duration=0.5),
               dict(num_force_polys=4, num_ee=2, num_phase_slots=9)):
        jc, pc = MPCConfig(**kw), PortCfg(**kw)
        for prop in ("horizon", "num_stance_slots", "num_footholds",
                     "num_force_vars", "num_pos_vars", "num_u"):
            assert getattr(pc, prop) == getattr(jc, prop), prop
    for kw in (dict(ls_alphas=1), dict(num_phase_slots=3),
               dict(double_support=0.3), dict(q_diag=(1.0,) * 11)):
        with pytest.raises(AssertionError):
            MPCConfig(**kw).validate()
        with pytest.raises(AssertionError):
            PortCfg(**kw).validate()
    assert hash(PortCfg()) == hash(PortCfg())


def test_from_config_round_trips_every_field():
    """convert.from_config copies field by field: a JAX-package config with
    every field moved off its default comes back equal."""
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig as PortCfg

    def moved(f):
        v = f.default
        if isinstance(v, bool):
            return not v
        if isinstance(v, int):
            return v + 2
        if isinstance(v, float):
            return v * 1.5 + 0.25
        if isinstance(v, str):
            return v + "_x"
        return tuple(x * 2.0 + 1.0 for x in v)

    changed = {f.name: moved(f) for f in dataclasses.fields(MPCConfig)}
    jc = MPCConfig(**changed)
    pc = convert.from_config(jc)
    assert type(pc) is PortCfg
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc) == changed
    assert dataclasses.asdict(convert.from_config(CFG)) == \
        dataclasses.asdict(CFG)
    assert convert.from_config(CFG).num_u == CFG.num_u


def _entry_points():
    from bilevel_gait_gen_tpu_torch.models import a1, srb
    from bilevel_gait_gen_tpu_torch.mpc import bilevel, gait, qp
    from bilevel_gait_gen_tpu_torch.ops import quat
    from bilevel_gait_gen_tpu_torch.problem import make_problem
    from bilevel_gait_gen_tpu_torch.utils import consts, stats
    from bilevel_gait_gen_tpu_torch.control.wbqp import WBQPConfig
    from bilevel_gait_gen_tpu_torch.sim import closed_loop
    from bilevel_gait_gen_tpu_torch.sim.engine import SimConfig
    from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig as PortCfg
    cfg = PortCfg().validate()
    f64 = torch.float64
    q0 = np.asarray(a1.stand_config(), np.float64)
    return {
        "make_problem": lambda **k: make_problem(cfg, 2, **k).x0s,
        "make_a1": lambda **k: a1.make_a1(**k).mass,
        "make_trot": lambda **k: gait.make_trot(cfg, dtype=f64, **k).bounds,
        "make_standing": lambda **k: gait.make_standing(cfg, dtype=f64,
                                                        **k).bounds,
        "init_curvature": lambda **k: bilevel.init_curvature(cfg, 2, **k).B,
        "convert.tensor": lambda **k: convert.tensor(np.zeros(3), **k),
        "convert.from_srb_params": lambda **k: convert.from_srb_params(
            _jax_state()[1], **k).mass,
        "convert.from_centroidal_state": lambda **k: (
            convert.from_centroidal_state(_jax_centroidal_state(), **k)
            .configs),
        "quat.identity": lambda **k: quat.identity(dtype=f64, **k),
        "srb.gravity": lambda **k: srb.gravity(f64, **k),
        "qp.friction_pyramid": lambda **k: qp.friction_pyramid(
            0.6, dtype=f64, **k),
        "consts.const": lambda **k: consts.const((1.0, 2.5), f64,
                                                 k.get("device")),
        "stats.make_ring": lambda **k: stats.make_ring(4, **k).data,
        "ClosedLoopController": lambda **k: closed_loop.ClosedLoopController(
            a1.make_a1(device="cpu"), cfg, WBQPConfig(), q0, np.zeros(18),
            **k).x_des,
        "push_recovery_scenario": lambda **k:
            closed_loop.push_recovery_scenario(**k)[0].mass,
        "torch_mpc_demo.setup": lambda **k: script("torch_mpc_demo").setup(
            cfg, k.get("device")).q0,
        "torch_batch_sim_demo.setup": lambda **k: script(
            "torch_batch_sim_demo").setup(cfg, SimConfig(), False,
                                          k.get("device"))[1],
        "torch_diag_engine.setup": lambda **k: script(
            "torch_diag_engine").setup(cfg, SimConfig(), k.get("device"))[1],
        "torch_hardware_sim_demo.setup": lambda **k: script(
            "torch_hardware_sim_demo").setup(cfg, True,
                                             k.get("device"))[2].mass,
        "torch_run_mujoco_walk.configure": lambda **k: script(
            "torch_run_mujoco_walk").configure([], k.get("device"))[
            "model"].mass,
        "make_mesh": _mesh_device,
    }


def _mesh_device(device=None):
    """An empty tensor on the device type of ``parallel.mesh.make_mesh``'s
    mesh, in a one-rank group of that device's backend."""
    from bilevel_gait_gen_tpu_torch.parallel import mesh, multihost
    with multihost.one_rank_group(device):
        return torch.empty(0, device=mesh.make_mesh(device=device).device_type)


def _jax_centroidal_state():
    from bilevel_gait_gen_tpu.mpc import centroidal as jcentroidal
    model, _, state, _, _ = _jax_state()
    q0 = jnp.asarray(ja1.stand_config(), jnp.float64)
    return jcentroidal.make_centroidal_state(CFG, model, state.traj,
                                             state.ee_box, q0)


@pytest.mark.parametrize("name", ["make_problem", "make_a1", "make_trot",
                                  "make_standing", "init_curvature",
                                  "convert.tensor",
                                  "convert.from_srb_params",
                                  "convert.from_centroidal_state",
                                  "quat.identity", "srb.gravity",
                                  "qp.friction_pyramid", "consts.const",
                                  "stats.make_ring", "ClosedLoopController",
                                  "push_recovery_scenario",
                                  "torch_mpc_demo.setup",
                                  "torch_batch_sim_demo.setup",
                                  "torch_diag_engine.setup",
                                  "torch_hardware_sim_demo.setup",
                                  "torch_run_mujoco_walk.configure",
                                  "make_mesh"])
def test_entry_points_default_to_the_gpu_and_take_the_cpu_on_request(name):
    """device=None means the CUDA device: without one the entry point
    raises and says so (nothing carries on on the CPU unasked); with
    device="cpu" it builds CPU tensors."""
    import bilevel_gait_gen_tpu_torch as port
    fn = _entry_points()[name]
    assert fn(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert fn().device.type == "cuda"
        assert port.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            port.default_device()
    assert port.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["WBQPConfig", "SimConfig"])
def test_wbqp_and_sim_config_copies_match_field_by_field(name):
    """The port's WBQPConfig and SimConfig have the JAX package's fields,
    in its order, with its defaults; convert copies every field, each moved
    off its default."""
    from bilevel_gait_gen_tpu.control import wbqp as jwbqp
    from bilevel_gait_gen_tpu.sim import engine as jengine
    from bilevel_gait_gen_tpu_torch.control import wbqp
    from bilevel_gait_gen_tpu_torch.sim import engine
    jcls, pcls, conv = {
        "WBQPConfig": (jwbqp.WBQPConfig, wbqp.WBQPConfig,
                       convert.from_wbqp_config),
        "SimConfig": (jengine.SimConfig, engine.SimConfig,
                      convert.from_sim_config)}[name]
    jf, pf = dataclasses.fields(jcls), dataclasses.fields(pcls)
    assert [(f.name, f.default) for f in pf] == \
        [(f.name, f.default) for f in jf]
    moved = {f.name: (f.default + 3 if isinstance(f.default, int)
                      else f.default * 1.5 + 0.25) for f in jf}
    got = conv(jcls(**moved))
    assert type(got) is pcls
    assert dataclasses.asdict(got) == moved
    assert conv(jcls()) == pcls()


def test_total_mass_is_built_once_as_before_the_repair(monkeypatch):
    """RobotModel.total_mass is the float32 link-order sum the property
    computed on every read before it was cached (the same bits), a tensor
    on the model's device, made by make_a1 and by convert; reading it
    copies nothing (Tensor.tolist is refused meanwhile)."""
    from bilevel_gait_gen_tpu_torch.models import a1
    jm = ja1.make_a1()
    acc = np.float32(0.0)
    for v in np.asarray(jm.mass).tolist():
        acc = np.float32(acc + np.float32(v))
    for m in (a1.make_a1(device="cpu"),
              convert.from_robot_model(jm, device="cpu")):
        assert m.total_mass.dtype == torch.float32
        assert m.total_mass.device == m.mass.device
        assert m.total_mass.numpy().view(np.int32) == np.asarray(acc).view(
            np.int32)
        assert np.asarray(jm.total_mass).view(np.int32) == \
            np.asarray(acc).view(np.int32)
    def refused(self):
        raise AssertionError("Tensor.tolist")

    monkeypatch.setattr(torch.Tensor, "tolist", refused)
    assert m.total_mass is m.total_mass
    assert float(m.total_mass * 9.81) > 134.0
