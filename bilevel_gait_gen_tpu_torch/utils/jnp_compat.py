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

from bilevel_gait_gen_tpu_torch.ops import kernels
from bilevel_gait_gen_tpu_torch.utils.consts import const


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


# a per-scenario product takes the batch-invariant kernel on the card when
# its matrix is at most MATVEC_SUM_WIDTH columns wide; a wider one keeps
# cuBLAS's batched GEMV or GEMM
MATVEC_SUM_WIDTH = 128


def _summed(M: torch.Tensor) -> bool:
    return M.is_cuda and M.shape[-1] <= MATVEC_SUM_WIDTH


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` for M [..., r, c] and v [..., c], batch axes broadcast.

    ``(M @ v[..., None])[..., 0]`` runs cuBLAS's batched GEMV, which picks
    its kernel, and how it splits each row's sum, by the batch count: a
    scenario's result then changes in its last bits with the number of
    scenarios beside it, and a closed loop amplifies that (PERF.md §6). On
    the card a matrix of at most MATVEC_SUM_WIDTH columns takes
    ``ops/kernels.bmv`` instead (``csrc/bmv.cu``), one launch that sums
    every entry in an order fixed by the row length alone. A wider matrix
    keeps the GEMV: the bench width's QP matrices (232 columns) gave every
    batch from 1 to 128 the same bits (PERF.md). CPU tensors keep the plain
    products and the bits the CPU tests were written against (there the
    closed loop's stages agree bit for bit at batches 4 and 8)."""
    if _summed(M):
        return kernels.bmv(M, v[..., None, :])[..., 0]
    return (M @ v[..., None])[..., 0]


def transposed(M: torch.Tensor) -> torch.Tensor | None:
    """M^T, contiguous, for :func:`vecmat` calls that share one M (made
    once, not at every call: the kernel then reads M^T's rows, not M's
    columns); None where :func:`vecmat` keeps the library product and needs
    none."""
    return M.mT.contiguous() if _summed(M) else None


def vecmat(v: torch.Tensor, M: torch.Tensor,
           Mt: torch.Tensor | None = None) -> torch.Tensor:
    """``v @ M`` (M^T v) for v [..., r] and M [..., r, c]; on the card, for
    the matrices :func:`matvec` takes to the kernel, the kernel on M^T
    (``Mt``, from :func:`transposed`, else M's transposed view, read by its
    strides)."""
    if _summed(M):
        return kernels.bmv(M.mT if Mt is None else Mt, v[..., None, :])[..., 0]
    return (v[..., None, :] @ M)[..., 0, :]


def matmul_nt(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X @ Y^T`` for X [..., a, k] and Y [..., b, k]: cuBLAS picks its
    batched GEMM by the batch count as it does its GEMV (:func:`matvec`), so
    on the card, for the matrices :func:`matvec` takes to the kernel, each
    entry is the kernel's dot product over the shared last axis."""
    if _summed(Y):
        return kernels.bmv(X, Y)
    return X @ Y.mT
