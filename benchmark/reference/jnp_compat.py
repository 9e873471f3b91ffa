"""Helpers that keep ``jax.numpy`` semantics where PyTorch differs.

``jnp.maximum``/``jnp.minimum`` split the cotangent in halves where the two
operands are equal, and ``jnp.clip`` is built from them.  ``torch.clamp``
instead passes the whole cotangent at the boundary.  The bilevel gradient
with respect to the contact times meets such ties on purpose (sample times
that land exactly on a phase boundary), so the differentiable code of the
port uses these helpers wherever the JAX package used ``maximum``/``clip``.
``take`` is ``jnp``-style indexing along one axis with broadcast batch
axes.  ``matvec`` / ``vecmat`` / ``matmul_nt`` are the per-scenario
products that ``jnp`` computes under ``vmap``, with each scenario's bits
independent of the batch.
"""
from __future__ import annotations

import torch

from .consts import const


def _as(x: torch.Tensor, v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return const(v, x.dtype, x.device)


def maximum(x: torch.Tensor, v) -> torch.Tensor:
    return torch.maximum(x, _as(x, v))


def minimum(x: torch.Tensor, v) -> torch.Tensor:
    return torch.minimum(x, _as(x, v))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))``."""
    return torch.minimum(_as(x, hi), torch.maximum(_as(x, lo), x))


def take(arr: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``arr[..., idx, *rest]`` along the negative axis ``dim``, with the
    leading axes of ``arr`` and ``idx`` broadcast against each other."""
    nrest = -dim - 1
    rest = tuple(arr.shape[arr.ndim - nrest:]) if nrest else ()
    lead = torch.broadcast_shapes(arr.shape[:dim], idx.shape)
    arr_e = arr.expand(*lead, arr.shape[dim], *rest)
    idx_e = idx.expand(lead).reshape(*lead, 1, *([1] * nrest))
    idx_e = idx_e.expand(*lead, 1, *rest)
    return torch.gather(arr_e, dim, idx_e).squeeze(dim)


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` for M [..., r, c] and v [..., c], batch axes broadcast."""
    return (M @ v[..., None])[..., 0]


def transposed(M: torch.Tensor) -> torch.Tensor | None:
    """None: the plain products read M by its strides."""
    return None


def vecmat(v: torch.Tensor, M: torch.Tensor,
           Mt: torch.Tensor | None = None) -> torch.Tensor:
    """``v @ M`` (M^T v) for v [..., r] and M [..., r, c]."""
    return (v[..., None, :] @ M)[..., 0, :]


def matmul_nt(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X @ Y^T`` for X [..., a, k] and Y [..., b, k]."""
    return X @ Y.mT
