"""Solve-stats ring buffer + table printer (port of
``bilevel_gait_gen_tpu/utils/stats.py``).

Replaces the reference's RecordStats/PrintStats/PrintStatLineToFile
(mpc/mpc.cpp:804-989): the same columns (solve #, time ms, constraint
violation, step norm, alpha, cost, merit, QP residuals, solved), kept as a
fixed-size ring buffer on the device.  :func:`record` makes no tensor from
host data and reads nothing back, so it can run inside a captured CUDA
graph; printing reads the ring back only when asked.

One ring holds one robot's solves: :func:`record` takes a ``SolveStats``
whose fields are scalars or batches of one.
"""
from __future__ import annotations

import dataclasses

import torch

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.utils.consts import filled

COLUMNS = ("solve", "time_ms", "defect_l1", "step_norm", "alpha", "cost",
           "merit", "qp_gap", "qp_pri", "qp_dua", "solved")


@dataclasses.dataclass(frozen=True)
class StatsRing:
    data: torch.Tensor   # [cap, len(COLUMNS)]
    head: torch.Tensor   # [] int32, rows recorded so far


def make_ring(capacity: int = 512, dtype: torch.dtype = torch.float32,
              device=None) -> StatsRing:
    """An empty ring of ``capacity`` rows (``device`` None means the GPU)."""
    device = resolve_device(device)
    return StatsRing(
        data=torch.zeros((capacity, len(COLUMNS)), dtype=dtype,
                         device=device),
        head=torch.zeros((), dtype=torch.int32, device=device))


def record(ring: StatsRing, solve_idx, time_ms, stats) -> StatsRing:
    """The ring with one more SolveStats row (on the device, no sync).
    ``solve_idx`` and ``time_ms`` are tensors or numbers."""
    dtype, dev = ring.data.dtype, ring.data.device

    def col(v):
        return filled(v, (), dtype, dev) if not isinstance(
            v, torch.Tensor) else v.to(dtype).reshape(())

    row = torch.stack([
        col(solve_idx), col(time_ms), col(stats.defect_l1),
        col(stats.step_norm), col(stats.alpha), col(stats.cost),
        col(stats.merit), col(stats.qp_gap), col(stats.qp_pri),
        col(stats.qp_dua), col(stats.solved)])
    cap = ring.data.shape[0]
    idx = torch.remainder(ring.head, cap).to(torch.int64).reshape(1)
    return StatsRing(data=ring.data.index_copy(0, idx, row[None]),
                     head=ring.head + 1)


def print_table(ring: StatsRing, last: int = 20, file=None) -> str:
    """Render the last rows as the reference's stats table (the JAX
    package's text, character for character)."""
    head = int(ring.head)
    cap = ring.data.shape[0]
    n = min(head, cap, last)
    rows = []
    data = ring.data.detach().cpu().numpy()
    for i in range(head - n, head):
        rows.append(data[i % cap])
    hdr = " | ".join(f"{c:>10s}" for c in COLUMNS)
    sep = "-" * len(hdr)
    lines = [hdr, sep]
    for r in rows:
        lines.append(" | ".join(f"{v:10.4g}" for v in r))
    out = "\n".join(lines)
    if file:
        with open(file, "a") as f:
            f.write(out + "\n")
    else:
        print(out)
    return out

