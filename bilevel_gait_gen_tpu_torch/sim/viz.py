"""Visualization / trajectory export (port of
``bilevel_gait_gen_tpu/sim/viz.py``).

Headless matplotlib summary plots in place of the reference's GLFW/MuJoCo
viewer overlays (simulation/visualization.cpp,
Simulator::UpdateVizGeoms): the logged rollout, the MPC plan over its
horizon and the plan seen from above.  ``matplotlib`` is imported inside
each function, so importing this module needs only torch and numpy.

A plan is the port's :class:`~bilevel_gait_gen_tpu_torch.mpc.trajectory.
Trajectory` of one robot, batch first with a batch of one (or without the
batch dimension), on any device.  Its splines are sampled with
``ops/spline.forces_all`` / ``foot_positions_all`` at all the plot's times
in one batched call, read back to the host once.
"""
from __future__ import annotations

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch.mpc.trajectory import Trajectory
from bilevel_gait_gen_tpu_torch.ops import spline


def _one(traj: Trajectory) -> Trajectory:
    """The trajectory without its batch of one."""
    if traj.x_man.dim() == 2:
        return traj
    if traj.x_man.shape[0] != 1:
        raise ValueError(f"a plot shows one robot's plan; this trajectory "
                         f"holds {traj.x_man.shape[0]}")
    return Trajectory(x_man=traj.x_man[0], f_nodes=traj.f_nodes[0],
                      footholds=traj.footholds[0],
                      sched=type(traj.sched)(bounds=traj.sched.bounds[0]))


def _times(traj: Trajectory, ts: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(ts, dtype=traj.x_man.dtype,
                           device=traj.x_man.device)


def _foot_samples(traj: Trajectory, cfg, ts: np.ndarray) -> np.ndarray:
    """Foot positions [T, E, 3] at the times ``ts`` [T]."""
    T = len(ts)
    b, fh = traj.sched.bounds, traj.footholds
    return spline.foot_positions_all(
        b.expand(T, *b.shape), fh.expand(T, *fh.shape), _times(traj, ts),
        cfg.swing_height, cfg.foot_offset).detach().cpu().numpy()


def _force_samples(traj: Trajectory, cfg, ts: np.ndarray) -> np.ndarray:
    """End-effector forces [T, E, 3] at the times ``ts`` [T]."""
    T = len(ts)
    b, fn = traj.sched.bounds, traj.f_nodes
    return spline.forces_all(
        b.expand(T, *b.shape), fn.expand(T, *fn.shape), _times(traj, ts),
        cfg.num_force_polys).detach().cpu().numpy()


def plot_rollout(qs: np.ndarray, taus: np.ndarray | None = None,
                 dt: float = 0.001, path: str = "rollout.png"):
    """Base state + torque summary plot for a logged rollout."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(len(qs)) * dt
    fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    axes[0].plot(t, qs[:, 0], label="x")
    axes[0].plot(t, qs[:, 1], label="y")
    axes[0].plot(t, qs[:, 2], label="z")
    axes[0].set_ylabel("base pos [m]")
    axes[0].legend()
    axes[0].grid(alpha=0.3)
    quat = qs[:, 3:7]
    axes[1].plot(t, quat)
    axes[1].set_ylabel("base quat")
    axes[1].grid(alpha=0.3)
    if taus is not None:
        axes[2].plot(t[:len(taus)], np.abs(taus).max(axis=1))
        axes[2].set_ylabel("|tau| max [Nm]")
    axes[2].set_xlabel("time [s]")
    axes[2].grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    return path


def plot_plan(traj: Trajectory, cfg, t0: float = 0.0,
              path: str = "plan.png"):
    """MPC plan overview: node states + spline forces/feet over the horizon
    (the headless analog of the viewer's trajectory overlay)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    traj = _one(traj)
    ts = np.linspace(t0, t0 + cfg.horizon, 200)
    forces = _force_samples(traj, cfg, ts)
    feet = _foot_samples(traj, cfg, ts)
    xs = traj.x_man.detach().cpu().numpy()
    tn = t0 + cfg.dt * np.arange(xs.shape[0])

    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    axes[0].plot(tn, xs[:, 2], "o-", label="plan z")
    axes[0].set_ylabel("COM z [m]")
    axes[0].grid(alpha=0.3)
    for e in range(forces.shape[1]):
        axes[1].plot(ts, forces[:, e, 2], label=f"ee{e}")
    axes[1].set_ylabel("fz [N]")
    axes[1].legend(ncol=4)
    axes[1].grid(alpha=0.3)
    for e in range(feet.shape[1]):
        axes[2].plot(ts, feet[:, e, 2], label=f"ee{e}")
    axes[2].set_ylabel("foot z [m]")
    axes[2].set_xlabel("time [s]")
    axes[2].grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    return path


def plot_plan_overlay(traj: Trajectory, cfg, params,
                      qs: np.ndarray | None = None, t0: float = 0.0,
                      path: str = "plan_overlay.png"):
    """Top-down overlay of the MPC plan: planned COM path, per-EE foothold
    targets, and the EE-box constraint rectangles around the hip
    projections (the headless equivalent of the viewer's trajectory +
    EE-box geoms, Simulator::UpdateVizGeoms).  Pass a logged rollout `qs`
    [T, nq] to draw the executed base path on top of the plan.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    traj = _one(traj)
    xs = traj.x_man.detach().cpu().numpy()               # [N+1, 13]
    hips = params.hip_offset.detach().cpu().numpy()      # [E, 2]
    box = np.asarray(cfg.ee_box_size, np.float64)
    E = hips.shape[0]

    ts = np.linspace(t0, t0 + cfg.horizon, 100)
    feet = _foot_samples(traj, cfg, ts)                  # [T, E, 3]
    footholds = traj.footholds.detach().cpu().numpy()    # [E, NF, 2]

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(xs[:, 0], xs[:, 1], "o-", color="tab:blue", label="plan COM")
    colors = plt.cm.tab10(np.arange(E))
    # EE boxes at a few sample nodes (the constraint is per node >= 4)
    for k in range(cfg.ee_node_start, xs.shape[0], 4):
        for e in range(E):
            cx = xs[k, 0] + hips[e, 0]
            cy = xs[k, 1] + hips[e, 1]
            ax.add_patch(Rectangle((cx - box[0] / 2, cy - box[1] / 2),
                                   box[0], box[1], fill=False,
                                   edgecolor=colors[e], alpha=0.25))
    for e in range(E):
        ax.plot(feet[:, e, 0], feet[:, e, 1], "--", color=colors[e],
                alpha=0.8, label=f"foot {e}")
        fh = footholds[e]                                # [NF, 2]
        ax.plot(fh[:, 0], fh[:, 1], "x", color=colors[e], markersize=8)
    if qs is not None:
        ax.plot(qs[:, 0], qs[:, 1], "-", color="black", linewidth=1.5,
                label="executed base")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
