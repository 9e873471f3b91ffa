"""Conversion of the JAX package's objects into the port's, and back to
numpy.

The ``from_*`` functions read the JAX objects' fields by name and turn each
array into a tensor with ``np.asarray`` (a JAX array converts without this
module importing jax); floating arrays take the requested dtype, integer and
bool arrays keep their kind.  Shapes are kept as they are: a single-scenario
JAX object gives single-scenario tensors, and the caller adds the leading
scenario dimension (for instance by stacking JAX objects first).
``to_numpy`` is the inverse used by the tests, so both sides can compute on
identical data.  ``device=None`` means the GPU
(:func:`bilevel_gait_gen_tpu_torch.default_device`); the CPU tests pass
``device="cpu"``.  :func:`from_config`, :func:`from_wbqp_config` and
:func:`from_sim_config` copy a JAX-package ``MPCConfig``, ``WBQPConfig`` and
``SimConfig`` into the port's own classes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.control.wbqp import WBQPConfig
from bilevel_gait_gen_tpu_torch.models.rbd import RobotModel
from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc.bilevel import OuterCurvature
from bilevel_gait_gen_tpu_torch.mpc.centroidal import CentroidalState
from bilevel_gait_gen_tpu_torch.mpc.gait import GaitSchedule
from bilevel_gait_gen_tpu_torch.mpc.qp import CondensedQP
from bilevel_gait_gen_tpu_torch.mpc.solver import SolverState
from bilevel_gait_gen_tpu_torch.mpc.trajectory import Trajectory
from bilevel_gait_gen_tpu_torch.ops.pdip import QPSolution
from bilevel_gait_gen_tpu_torch.sim.engine import SimConfig
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig


def tensor(a, *, device=None, dtype: torch.dtype = torch.float64
           ) -> torch.Tensor:
    arr = np.array(a)        # a copy: JAX hands out read-only buffers
    t = torch.from_numpy(arr).to(resolve_device(device))
    return t.to(dtype) if arr.dtype.kind == "f" else t


def _fields(obj, cls, *, device, dtype, skip=()):
    return {f.name: tensor(getattr(obj, f.name), device=device, dtype=dtype)
            for f in dataclasses.fields(cls) if f.name not in skip}


def from_config(cfg) -> MPCConfig:
    """The port's ``MPCConfig`` with every field of a JAX-package
    ``MPCConfig`` (a frozen dataclass with the same field names)."""
    return MPCConfig(**dataclasses.asdict(cfg))


def from_wbqp_config(c) -> WBQPConfig:
    """The port's ``WBQPConfig`` with every field of a JAX-package one."""
    return WBQPConfig(**dataclasses.asdict(c))


def from_sim_config(c) -> SimConfig:
    """The port's ``SimConfig`` with every field of a JAX-package one."""
    return SimConfig(**dataclasses.asdict(c))


def from_robot_model(m, *, device=None) -> RobotModel:
    """The model's arrays stay float32, as the JAX make_a1 keeps them."""
    static = ("parent", "ee_link", "hip_link", "ee_names", "joint_names")
    kw = {name: tuple(getattr(m, name)) for name in static}
    # total_mass is left out: the model computes it when it is made
    kw.update(_fields(m, RobotModel, device=device, dtype=torch.float32,
                      skip=static + ("total_mass",)))
    return RobotModel(**kw)


def from_srb_params(p, *, device=None, dtype=torch.float64) -> SRBParams:
    return SRBParams(**_fields(p, SRBParams, device=device, dtype=dtype))


def from_gait_schedule(s, *, device=None, dtype=torch.float64) -> GaitSchedule:
    return GaitSchedule(bounds=tensor(s.bounds, device=device, dtype=dtype))


def from_trajectory(t, *, device=None, dtype=torch.float64) -> Trajectory:
    return Trajectory(
        x_man=tensor(t.x_man, device=device, dtype=dtype),
        f_nodes=tensor(t.f_nodes, device=device, dtype=dtype),
        footholds=tensor(t.footholds, device=device, dtype=dtype),
        sched=from_gait_schedule(t.sched, device=device, dtype=dtype))


def from_qp_solution(s, *, device=None, dtype=torch.float64) -> QPSolution:
    kw = _fields(s, QPSolution, device=device, dtype=dtype)
    kw["iters"] = kw["iters"].to(torch.int32)
    return QPSolution(**kw)


def from_solver_state(st, *, device=None, dtype=torch.float64) -> SolverState:
    warm = (None if st.qp_warm is None else
            from_qp_solution(st.qp_warm, device=device, dtype=dtype))
    return SolverState(traj=from_trajectory(st.traj, device=device,
                                            dtype=dtype),
                       ee_box=tensor(st.ee_box, device=device, dtype=dtype),
                       qp_warm=warm)


def from_centroidal_state(st, *, device=None,
                          dtype=torch.float64) -> CentroidalState:
    """A JAX-package ``CentroidalState``; ``qp_warm`` and ``vj`` stay None
    where they are."""
    def opt(a):
        return None if a is None else tensor(a, device=device, dtype=dtype)

    warm = (None if st.qp_warm is None else
            from_qp_solution(st.qp_warm, device=device, dtype=dtype))
    return CentroidalState(
        traj=from_trajectory(st.traj, device=device, dtype=dtype),
        ee_box=tensor(st.ee_box, device=device, dtype=dtype),
        configs=tensor(st.configs, device=device, dtype=dtype),
        qp_warm=warm, vj=opt(st.vj))


def from_condensed_qp(qp, *, device=None, dtype=torch.float64) -> CondensedQP:
    return CondensedQP(**_fields(qp, CondensedQP, device=device, dtype=dtype))


def from_outer_curvature(c, *, device=None,
                         dtype=torch.float64) -> OuterCurvature:
    return OuterCurvature(**_fields(c, OuterCurvature, device=device,
                                    dtype=dtype))


def to_numpy(obj):
    """The same structure with every tensor replaced by a numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_numpy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(to_numpy(o) for o in obj)
    return obj
