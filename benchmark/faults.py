"""Faults planted in the program underneath a run, to show that the
comparison which decides ``correct`` sees them: the benchmark's fault test
runs each on the CPU at a small size, and ``control.py --fault <name>``
reads one on the card at the cell's own size.

Each fault takes ``patch(module, name, value)`` (pytest's
``monkeypatch.setattr``, or ``setattr`` in a process that ends after) and
replaces one entry of the program by a broken one."""
from __future__ import annotations

import dataclasses


def unchanged(patch) -> None:
    """Every real-time iteration hands back the state it was given."""
    from bilevel_gait_gen_tpu_torch.mpc import solver
    orig = solver.solve_step

    def broken(cfg, params, state, *args, **kw):
        return (state,) + tuple(orig(cfg, params, state, *args, **kw)[1:])
    patch(solver, "solve_step", broken)


def half_batch(patch) -> None:
    """Every real-time iteration solves the first half of its scenarios
    and hands their answers to the second half too."""
    import torch
    from bilevel_gait_gen_tpu_torch.mpc import solver
    from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map
    orig = solver.solve_step

    def broken(cfg, params, state, x0, *args, **kw):
        h = x0.shape[0] // 2
        if h == 0:
            return orig(cfg, params, state, x0, *args, **kw)
        first = tree_map(lambda t: t[:h] if t.ndim else t,
                         (state, x0) + args)
        out = orig(cfg, params, *first, **kw)
        return tree_map(lambda t: torch.cat([t, t]) if t.ndim else t, out)
    patch(solver, "solve_step", broken)


def altered_gait(patch) -> None:
    """The gait update's objective comes out half as large again."""
    from bilevel_gait_gen_tpu_torch.mpc import bilevel
    orig = bilevel.gait_opt_update

    def broken(*args, **kw):
        res = orig(*args, **kw)
        return dataclasses.replace(res, cost=res.cost * 1.5)
    patch(bilevel, "gait_opt_update", broken)


def altered_torque(patch) -> None:
    """Every torque command comes out 0.5 N m higher."""
    from bilevel_gait_gen_tpu_torch.control import mpc_controller
    orig = mpc_controller.control_action

    def broken(*args, **kw):
        return orig(*args, **kw) + 0.5
    patch(mpc_controller, "control_action", broken)


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered_gait,
                                  altered_torque)}
