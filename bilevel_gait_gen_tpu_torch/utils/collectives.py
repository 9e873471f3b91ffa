"""The one collective the port makes across processes: an all-gather on a
``torch.distributed`` group (the counterpart of ``jax.lax.all_gather``).

Two ranks on one card cannot share an NCCL communicator (NCCL refuses a
device twice), so such a group is ``gloo``, and :func:`all_gather` stages
its tensors through host memory.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) concatenated along ``dim``
    in rank order, on ``t``'s device; ``group`` None is the whole process
    group.

    For a ``gloo`` group the tensor always goes through host memory (a
    copy to the CPU before the collective and back after it): that is how
    two ranks that share one card gather.  NCCL gathers on the device."""
    src = t.contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)
