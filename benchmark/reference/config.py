"""Configuration dataclass (the port's ``utils/config.py``, itself a copy of
``bilevel_gait_gen_tpu/utils/config.py``: same field names, defaults,
``validate()`` and derived properties; the rationale of every default is
documented there).

One frozen dataclass, validated and hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static MPC problem configuration.

    Shape-determining fields (all Python ints):
      num_nodes:        horizon nodes N
      num_ee:           end effectors E
      num_force_polys:  cubic force polynomials per stance phase F
      num_phase_slots:  fixed phase slots P per EE covering the horizon plus
                        margin; even slots are stance, odd are swing
      samples_per_stance: force-sample points per stance for the friction
                        cone / force box
      ee_node_start:    first node with an EE-box constraint
    """
    # Shapes
    num_nodes: int = 20
    num_ee: int = 4
    num_force_polys: int = 3
    num_phase_slots: int = 8
    samples_per_stance: int = 10
    ee_node_start: int = 4

    # Timing
    dt: float = 0.05
    integrator: str = "euler"       # "euler" or "rk2"

    # Physical / constraint parameters
    friction_coef: float = 0.5
    force_bound: float = 150.0
    swing_height: float = 0.075
    foot_offset: float = 0.015
    ee_box_size: Tuple[float, float] = (0.15, 0.15)

    # Costs
    q_diag: Tuple[float, ...] = (340.0, 340.0, 4000.0,
                                 0.1, 0.1, 10.0,
                                 3000.0, 3000.0, 3000.0,
                                 1.0, 1.0, 1.0)
    force_cost: float = 0.0
    diag_reg: float = 1e-3

    # Raibert-heuristic touchdown constraint: equality rows pinning each
    # in-horizon touchdown foothold to COM_xy(td node) + hip offset
    # (+ raibert_vel_gain * T_stance/2 * v_com).  Off by default.  When a
    # touchdown is also claimed by the TD-pin constraint the pin wins (the
    # Raibert row is masked off for that EE).
    raibert: bool = False
    raibert_vel_gain: float | Tuple[float, float] = 0.0
    # per-axis scale on the hip-offset constant term of the Raibert rows
    raibert_hip_scale: Tuple[float, float] = (1.0, 1.0)

    # SQP / merit
    merit_mu: float = 5000.0
    max_ls_iters: int = 10
    init_run_iters: int = 10
    td_fraction: float = 0.75

    # Interior-point solver
    ipm_iters: int = 25
    ipm_tol: float = 1e-9
    # exact inverse refresh cadence (Newton-Schulz tracking in between);
    # > 1 is safe for warm-started RTI problems
    ipm_exact_every: int = 3
    # QP inner-iteration path: "xla" = the unrolled tensor-code sweeps,
    # "pallas" = the fused sweep kernel (``ops/kernels.py::ipm_iter``); the
    # values keep the JAX package's names
    qp_kernel: str = "xla"
    # QP algorithm: "pdip" = interior point, "admm" = operator splitting
    qp_backend: str = "pdip"
    admm_iters: int = 400
    # exact-refresh SPD inverse: "chol" = Cholesky + two triangular passes,
    # "gj" = the blocked Gauss-Jordan kernel with shift and guarded
    # Newton-Schulz deflation (``ops/kernels.py::spd_inverse``; experimental:
    # sound on cold and moderate-W matrices, while warm-started solves clip
    # W into a range whose float32 deflation never converges), "schur" = the
    # shifted recursive Schur inverse in tensor code
    ipm_inverse: str = "chol"

    # Gait schedule defaults
    phase_duration: float = 0.3
    # double-support overlap [s]: stances last phase_duration +
    # double_support, swings phase_duration - double_support
    double_support: float = 0.0
    # early-touchdown snap window [s]
    contact_snap_window: float = 0.07
    # static-support force carrier: plan forces = carrier(t, bounds) +
    # spline(u), with ``carrier_ramp``-long weight-transfer ramps
    force_carrier: bool = False
    carrier_ramp: float = 0.1

    # Outer (gait) optimizer
    min_dwell: float = 0.2
    trust_region: float = 1.0       # initial radius
    # per EE, freeze this many upcoming phase boundaries (after pinning all
    # past ones) in the projection QP
    gait_freeze_boundaries: int = 1
    # alpha-grid size including alpha = 0, all run as lanes of the same cold
    # reduced-depth pipeline (``bilevel._lane_search``)
    ls_alphas: int = 4
    # IPM sweeps inside the line-search lanes (0 = ipm_iters)
    ls_ipm_iters: int = 4
    # Newton-Schulz cadence inside the lanes (1 = all exact)
    ls_exact_every: int = 5
    # roll the carried IPM warm start's primal in lockstep with window shifts
    warm_roll: bool = False
    # damped-BFGS curvature on the outer objective: ``gait_opt_update``
    # threads an OuterCurvature carry (pass ``res.curv`` back in as ``curv``)
    gait_bfgs: bool = False
    # extra IPM polish sweeps on the captured RTI solution before the IFT
    # gradient is taken (0 = gradient exactly at the RTI solution)
    ipm_grad_polish: int = 0
    # projection-QP iteration budget (``contact_time_step``)
    proj_iters: int = 15
    # trust-region acceptance and adaptation
    tr_eta_low: float = 0.1
    tr_eta_high: float = 0.75
    tr_shrink: float = 0.5
    tr_grow: float = 2.0
    tr_min: float = 0.01

    @property
    def horizon(self) -> float:
        return self.num_nodes * self.dt

    @property
    def num_stance_slots(self) -> int:
        # even slots 0, 2, ... are stance; odd are swing
        return (self.num_phase_slots + 1) // 2

    @property
    def num_footholds(self) -> int:
        # foothold s covers stance slot 2s; the final swing slot needs one
        # more target foothold past the last stance slot
        return self.num_stance_slots + 1

    @property
    def num_force_vars(self) -> int:
        # interior FullDeriv nodes only: (F-1) nodes x 3 coords x (val, dval)
        return (self.num_ee * self.num_stance_slots
                * (self.num_force_polys - 1) * 3 * 2)

    @property
    def num_pos_vars(self) -> int:
        return self.num_ee * self.num_footholds * 2

    @property
    def num_u(self) -> int:
        return self.num_force_vars + self.num_pos_vars

    def validate(self) -> "MPCConfig":
        assert self.num_force_polys >= 2
        assert self.num_phase_slots >= 2
        assert self.num_nodes >= 1
        assert len(self.q_diag) == 12
        # the phase slots must cover the horizon with margin for window shifts
        cover = (self.num_phase_slots - 2) * self.phase_duration
        assert cover >= self.horizon, (
            f"num_phase_slots={self.num_phase_slots} x {self.phase_duration}s "
            f"cannot cover horizon {self.horizon}s + shift margin")
        assert 0.0 <= self.double_support < self.phase_duration, (
            "double_support must be in [0, phase_duration)")
        if self.double_support > 0.0:
            assert self.num_phase_slots % 2 == 0, (
                "overlapped trot window extension assumes an even slot count")
        # alpha = 0 rides the embedded RTI, so at least one paid lane is
        # required for the grid to scan any magnitude at all
        assert self.ls_alphas >= 2, "ls_alphas counts alpha=0; need >= 2"
        assert self.gait_freeze_boundaries >= 0
        assert self.proj_iters >= 1
        return self
