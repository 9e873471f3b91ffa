"""Multi-process start-up and the global scenario mesh over
``torch.distributed`` (port of ``bilevel_gait_gen_tpu/parallel/
multihost.py``).

The JAX module wraps ``jax.distributed``.  Here a process joins a
``torch.distributed`` process group through an init method
(``tcp://host:port``, ``file:///path`` or ``env://``), the global mesh is a
``DeviceMesh`` over every rank, and a process's local batch becomes its
shard of a ``DTensor``.  What crosses processes goes through
``all_gather`` (``utils/collectives``, re-exported here): two ranks on one
card share no NCCL communicator (NCCL refuses a device twice), so such a
group is ``gloo``, whose gathers go through host memory.  A mesh needs a
process group: :func:`initialize` joins one, and :func:`one_rank_group`
makes one of this process alone.  scripts/torch_multihost_demo.py runs two
local processes through this module.
"""
from __future__ import annotations

import contextlib
import os

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from bilevel_gait_gen_tpu_torch import resolve_device
from bilevel_gait_gen_tpu_torch.utils.collectives import (  # noqa: F401
    all_gather)
from bilevel_gait_gen_tpu_torch.utils.graphs import tree_map


def default_backend(device=None) -> str:
    """``"nccl"`` for the card (``device`` None means the card), ``"gloo"``
    for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               backend: str | None = None) -> bool:
    """Join the process group from the arguments or from the variables
    torchrun sets: ``MASTER_ADDR`` (with ``MASTER_PORT``) makes the init
    method ``env://``, ``WORLD_SIZE`` the number of processes, ``RANK``
    the process id.  ``coordinator`` is a ``torch.distributed`` init
    method.  Returns False, and joins nothing, without a coordinator
    (one process).  ``backend`` None means :func:`default_backend` of
    ``device``."""
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = "env://"
    if coordinator is None:
        return False  # single process
    # `is None` (not falsy-or): an explicit process_id=0 must not be
    # overridden by the environment
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend or default_backend(device),
                            init_method=coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


@contextlib.contextmanager
def one_rank_group(device=None):
    """A process group of this process alone, on an in-process store, for
    the ``with`` block (the counterpart of the JAX package's
    single-process mesh): ``nccl`` on the card, ``gloo`` with
    ``device="cpu"``.  Refuses to start inside another group."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group(default_backend(device), store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def device_mesh(axis_sizes, axis_names, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_sizes`` over the ranks of the process
    group (row-major, as ``Mesh(devices.reshape(sizes))``), on ``device``'s
    type (None: the card).  Raises without a process group
    (:func:`initialize`, or :func:`one_rank_group` for one process)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "multihost.initialize, or enter "
                           "multihost.one_rank_group() for one process")
    return init_device_mesh(device.type, tuple(axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def global_mesh(axis_name: str = "scenario", *, device=None) -> DeviceMesh:
    """1-D mesh over all ranks of all processes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return device_mesh((world,), (axis_name,), device)


def placements(mesh: DeviceMesh, axis: str, dim: int = 0) -> list:
    """Sharded on dimension ``dim`` over ``axis``, replicated over the
    mesh's other axes."""
    return [Shard(dim) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def host_local_batch_to_global(tree, mesh: DeviceMesh,
                               axis: str = "scenario"):
    """Each process's batch as its shard of one global batch: every
    tensor of ``tree`` becomes a ``DTensor`` sharded on dimension 0 over
    ``axis`` (the counterpart of
    ``jax.make_array_from_process_local_data``)."""
    return tree_map(lambda x: DTensor.from_local(
        x, mesh, placements(mesh, axis), run_check=False), tree)
