"""The bench cadence's loops, batch first: the bodies of ``bench.py``'s
jitted functions.

``bench.py`` runs each of these as one jitted dispatch around a
``lax.scan``.  Here each is a plain function over B scenarios that runs
eagerly as it is (the CPU tests, the eager column of ``bench_torch.py``)
and that ``utils.graphs.Graphed`` captures as one CUDA graph on the card.
The arguments after ``params`` are those of ``solver.solve_step``: the
state, x0s [B, 13], t0 [B], feets [B, E, 3] and x_des [B, 12].

* :func:`cycle`: ``freq - 1`` real-time iterations, then one gait update
  (``cadence``, bench.py:132-150; ``cadence50``, :355-366);
* :func:`rti_block`: real-time iterations in a row (``rti_block``,
  :153-158; the N=50 block, :338-343; the A/B arms' blocks and settling,
  :278-290; at batch 1 the chained single-robot RTIs of ``chain``,
  :194-199);
* :func:`gait_chain`: gait updates in a row with the trust radius carried
  (``gait_chain``, :226-234; at length 1 the A/B arm's ``vgait_ab``).
"""
from __future__ import annotations

import torch

from bilevel_gait_gen_tpu_torch.models.srb import SRBParams
from bilevel_gait_gen_tpu_torch.mpc import bilevel, solver
from bilevel_gait_gen_tpu_torch.utils.config import MPCConfig


def rti_block(cfg: MPCConfig, params: SRBParams, st: solver.SolverState,
              x0s: torch.Tensor, t0: torch.Tensor, feets: torch.Tensor,
              x_des: torch.Tensor, length: int):
    """``length`` real-time iterations in a row.  Returns (state,
    cost [length, B], solved [length, B])."""
    costs, solved = [], []
    for _ in range(length):
        st, stats = solver.solve_step(cfg, params, st, x0s, t0, feets, x_des)
        costs.append(stats.cost)
        solved.append(stats.solved)
    return st, torch.stack(costs), torch.stack(solved)



def cycle(cfg: MPCConfig, params: SRBParams, st: solver.SolverState,
          x0s: torch.Tensor, t0: torch.Tensor, feets: torch.Tensor,
          x_des: torch.Tensor, freq: int):
    """One cadence cycle: ``freq - 1`` real-time iterations, then one full
    gait update in place of the ``freq``-th.  Returns (state,
    solved [freq - 1, B], the gait update's ``GaitOptResult``, solved_frac),
    solved_frac the float32 share of solved RTIs with the gait update's
    embedded RTI weighted as one of ``freq``."""
    if freq < 2:
        raise ValueError(f"freq={freq}: a cycle has at least one RTI")
    st, _, solved = rti_block(cfg, params, st, x0s, t0, feets, x_des,
                              freq - 1)
    gres = bilevel.gait_opt_update(cfg, params, st, x0s, t0, feets, x_des)
    solved_frac = (solved.float().mean() * (freq - 1) / freq
                   + gres.rti_stats.solved.float().mean() / freq)
    return gres.state, solved, gres, solved_frac


def gait_chain(cfg: MPCConfig, params: SRBParams, st: solver.SolverState,
               trust: torch.Tensor, x0s: torch.Tensor, t0: torch.Tensor,
               feets: torch.Tensor, x_des: torch.Tensor, length: int):
    """``length`` gait updates in a row, each starting from the last one's
    state and trust radius (trust [B]).  Returns (state, trust,
    cost [length, B], accepted [length, B])."""
    costs, accepted = [], []
    for _ in range(length):
        res = bilevel.gait_opt_update(cfg, params, st, x0s, t0, feets, x_des,
                                      trust=trust)
        st, trust = res.state, res.trust
        costs.append(res.cost)
        accepted.append(res.accepted)
    return st, trust, torch.stack(costs), torch.stack(accepted)
