"""The golden rollout contract: the port's counterpart of
``scripts/gen_golden.py::rollout`` and of ``scripts/parity_tpu.py``'s check.

The JAX package pins one float64 rollout of the A1 walk configuration
(N=20, dt=0.05, trot) in ``tests/golden/a1_trot.npz``: the initial SQP, 10
receding-horizon RTIs, each advancing t0 by dt and taking x0 from the plan's
node 1, then the outer bilevel gradient at t = 10 dt.  :func:`rollout` runs
the same sequence at batch 1 through the port's own functions, and
:func:`parity_report` holds a result to the golden at ``parity_tpu.py``'s
bounds.  The port keeps no copy of the npz: it reads the JAX package's.
``chip_smoke.py`` phase 13 runs the float32 rollout on the card, as
parity_tpu.py runs it on the TPU; ``tests/test_torch_parity.py`` runs both
dtypes on the CPU.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.models import a1, rbd, srb
from bilevel_gait_gen_tpu_torch.mpc import bilevel, gait, solver
from bilevel_gait_gen_tpu_torch.mpc.trajectory import default_trajectory
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig

GOLDEN = (Path(__file__).resolve().parent.parent / "tests" / "golden"
          / "a1_trot.npz")
# scripts/parity_tpu.py's bounds: states, relative costs, gradient cosine
DX_BOUND = 5e-3
DC_BOUND = 1e-2
COS_BOUND = 0.99


def load_golden() -> dict:
    """The pinned rollout: ``xs`` [10, 13], ``costs`` [10], ``grad``
    [4, 9] and ``cost0`` (a float)."""
    with np.load(GOLDEN) as z:
        return {"xs": z["xs"], "costs": z["costs"], "grad": z["grad"],
                "cost0": float(z["cost0"])}


def rollout(dtype: torch.dtype = torch.float64, device=None):
    """Deterministic open-loop MPC rollout: initial SQP + 10 receding-horizon
    RTI steps, each advancing t0 by dt and taking x0 from the plan's next
    node (gen_golden.py:28-64, at batch 1).  Returns (xs [10, 13],
    costs [10], grad [4, 9]) as float64 numpy and cost0, the initial run's
    cost, as a float.  ``device`` defaults to the GPU."""
    dev = resolve_device(device)
    cfg = MPCConfig().validate()        # N=20, dt=0.05 A1 walk config
    model = a1.make_a1(device=dev)
    q0 = torch.tensor(a1.stand_config(), dtype=dtype, device=dev)
    params = srb.make_srb_params(model, q0)
    x0 = srb.reconstruct_state(params, q0, torch.zeros(model.nv, dtype=dtype,
                                                       device=dev))[None]
    feet0 = rbd.ee_positions(model, q0).to(dtype)[None]
    traj = default_trajectory(cfg, gait.make_trot(cfg, dtype=dtype,
                                                  device=dev),
                              x0, feet0[..., :2])
    st = solver.SolverState(traj=traj, ee_box=torch.tensor(
        [cfg.ee_box_size], dtype=dtype, device=dev))
    x_des = srb.manifold_to_tangent(x0)
    st, stats0 = solver.create_initial_run(cfg, params, st, x0, feet0, x_des)

    xs, costs = [], []
    x_cur = x0
    for k in range(10):
        t0 = torch.full((1,), k * cfg.dt, dtype=dtype, device=dev)
        st, stats = solver.solve_step(cfg, params, st, x_cur, t0, feet0,
                                      x_des)
        # next measured state = the plan's node-1 prediction (open loop)
        x_cur = st.traj.x_man[:, 1]
        xs.append(x_cur[0].cpu().numpy().astype(np.float64))
        costs.append(float(stats.cost[0]))

    g = bilevel.outer_gradient(cfg, params, st.traj, x_cur,
                               torch.full((1,), 10 * cfg.dt, dtype=dtype,
                                          device=dev), feet0, x_des,
                               st.ee_box)
    return (np.stack(xs), np.asarray(costs, np.float64),
            g[0].cpu().numpy().astype(np.float64), float(stats0.cost[0]))


def parity_report(golden: dict, result) -> dict:
    """``result`` (what :func:`rollout` returns) against ``golden``, as
    parity_tpu.py computes it: ``dx`` max |x - x_golden| over all of xs,
    ``dc`` the max cost difference relative to 1 + |cost_golden|, ``cos``
    the outer gradients' cosine, and ``ok``: all three within the bounds
    and every value of the result finite."""
    xs, costs, grad, _ = result
    dx = float(np.max(np.abs(xs - golden["xs"])))
    dc = float(np.max(np.abs(costs - golden["costs"])
                      / (1.0 + np.abs(golden["costs"]))))
    g64 = golden["grad"].ravel()
    cos = float(np.dot(g64, grad.ravel())
                 / (np.linalg.norm(g64) * np.linalg.norm(grad) + 1e-30))
    finite = bool(np.all(np.isfinite(xs)) and np.all(np.isfinite(costs))
                  and np.all(np.isfinite(grad)))
    ok = dx < DX_BOUND and dc < DC_BOUND and cos > COS_BOUND and finite
    return {"dx": dx, "dc": dc, "cos": cos, "finite": finite, "ok": ok}

