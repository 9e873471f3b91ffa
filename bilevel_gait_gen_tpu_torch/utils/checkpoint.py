"""Checkpoint / resume for the control-loop carry state (port of
``bilevel_gait_gen_tpu/utils/checkpoint.py``).

The reference has none (SURVEY §5); its persistent cross-step state is the
warm start (prev_traj_/prev_qp_sol/prev_dual_sol_, mpc/include/mpc.h:
267-291).  Here that state is a pytree of tensors (``SolverState``, a stats
ring, dicts of them), so a checkpoint is a host dump of its leaves: an
``.npz`` of ``leaf_i`` arrays and a JSON sidecar with the structure, the
leaves' shapes and free metadata.

The leaves are numbered in the order in which ``jax.tree.flatten`` visits
the JAX package's counterpart (dataclass fields and tuple entries in order,
dict entries by sorted key, ``None`` no leaf), so a state converted from
the JAX package saves the same ``leaf_i`` arrays as the JAX ``save``.  The
sidecar's structure string is the port's own.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from bilevel_gait_gen_tpu_torch.utils.graphs import tree_leaves, tree_map


def _canonical(tree):
    """``tree`` with every dict's entries in sorted key order (the order
    of ``jax.tree.flatten``); tensors are not copied."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _canonical(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        parts = [_canonical(t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else \
            type(tree)(parts)
    return tree


def _structure(tree) -> str:
    """The tree's structure with every tensor shown as ``*``."""
    return repr(tree_map(lambda _: "*", tree))


def save(path: str, tree: Any, metadata: dict | None = None) -> str:
    """Dump a pytree of tensors to an .npz (+ structure sidecar)."""
    tree = _canonical(tree)
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    side = {
        "treedef": _structure(tree),
        "num_leaves": len(leaves),
        "leaf_shapes": [list(a.shape) for a in arrays.values()],
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(side, f, indent=1)
    return path


class StructureMismatch(ValueError):
    """The checkpoint's pytree structure does not match the `like` template."""


def load(path: str, like: Any) -> Any:
    """Restore a pytree saved by :func:`save`; ``like`` supplies the
    structure, dtypes and devices to restore into.

    Checks before restoring: the leaf count and every leaf's shape, then
    the stored structure string (when the sidecar exists) -- a structurally
    different pytree with an equal leaf count must not load into the wrong
    slots."""
    like = _canonical(like)
    leaves = tree_leaves(like)
    with np.load(path) as data:
        if len(leaves) != len(data.files):
            raise StructureMismatch(
                f"checkpoint has {len(data.files)} leaves, expected "
                f"{len(leaves)}")
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for i, (arr, leaf) in enumerate(zip(arrays, leaves)):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise StructureMismatch(
                f"checkpoint leaf {i} has shape {tuple(arr.shape)}, "
                f"template expects {tuple(leaf.shape)}")
    side_path = path + ".json"
    if os.path.exists(side_path):
        with open(side_path) as f:
            stored = json.load(f).get("treedef")
        if stored is not None and stored != _structure(like):
            raise StructureMismatch(
                "checkpoint structure does not match the template:\n"
                f"  stored:   {stored}\n  template: {_structure(like)}")
    it = iter(torch.from_numpy(a) for a in arrays)
    return tree_map(lambda leaf: next(it).to(dtype=leaf.dtype,
                                             device=leaf.device), like)


def metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)["metadata"]
