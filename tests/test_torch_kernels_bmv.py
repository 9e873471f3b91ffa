"""``csrc/bmv.cu`` compiled for the host (``torch_kernel_common.host_lib``)
through ``kernels.bmv``'s CUDA branch on CPU tensors.

* against its plain version (``kernels.bmv_reference``) in float32 and
  float64, on both of its paths (one thread an entry up to K = 32, one warp
  an entry past it), broadcast, transposed and strided operands, and more
  batch axes than the kernel addresses: each entry within K eps of its
  sum_k |X_k Y_k| (``kernel_checks.bmv_err`` <= 1, the first-order bound
  of two orders of summation);
* a scenario's bits at batches 1, 3 and 8: the property the kernel exists
  for (the card's cuBLAS GEMV gave a scenario other bits at another batch);
* its autograd rules (``kernels._Bmv``): gradients, ``jacfwd`` under
  ``vmap`` and reverse mode over that, as ``srb.linearize`` and the outer
  gradient take them, against the same functions on ``@``.

Shapes are small: an emulated launch starts a thread per CUDA thread (32 a
warp-path entry) under a lock that the test processes share.
"""
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu_torch.ops import kernels
from bilevel_gait_gen_tpu_torch.ops.kernel_checks import bmv_err

from torch_kernel_common import host_lib, host_card  # noqa: F401

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, dtype=dtype)


# (id, X and Y from a generator and a dtype): X [..., a, k], Y [..., b, k]
CASES = {
    "matvec-thread-k12": lambda g, d: (_randn(g, 3, 7, 12, dtype=d),
                                       _randn(g, 3, 1, 12, dtype=d)),
    "matvec-k1": lambda g, d: (_randn(g, 2, 5, 1, dtype=d),
                               _randn(g, 2, 1, 1, dtype=d)),
    "matvec-k32-last-thread-path": lambda g, d: (
        _randn(g, 2, 4, 32, dtype=d), _randn(g, 2, 1, 32, dtype=d)),
    "matvec-k33-first-warp-path": lambda g, d: (
        _randn(g, 2, 3, 33, dtype=d), _randn(g, 2, 1, 33, dtype=d)),
    "matvec-warp-k70": lambda g, d: (_randn(g, 2, 3, 70, dtype=d),
                                     _randn(g, 2, 1, 70, dtype=d)),
    "shared-3x3-over-vectors": lambda g, d: (_randn(g, 3, 3, dtype=d),
                                             _randn(g, 7, 1, 3, dtype=d)),
    "one-vector-over-matrices": lambda g, d: (_randn(g, 4, 6, 12, dtype=d),
                                              _randn(g, 1, 12, dtype=d)),
    "vecmat-transposed-view": lambda g, d: (
        _randn(g, 2, 40, 5, dtype=d).mT, _randn(g, 2, 1, 40, dtype=d)),
    "matmul-nt-warp": lambda g, d: (_randn(g, 2, 4, 36, dtype=d),
                                    _randn(g, 2, 3, 36, dtype=d)),
    "rows-of-a-wider-tensor": lambda g, d: (
        _randn(g, 3, 5, 20, dtype=d)[..., 2:14],
        _randn(g, 3, 2, 24, dtype=d)[..., ::2]),
    "four-batch-axes-apart": lambda g, d: (
        _randn(g, 2, 1, 3, 1, 4, 5, dtype=d).mT.mT,
        _randn(g, 1, 2, 1, 3, 1, 5, dtype=d)),
    "k0": lambda g, d: (torch.ones(2, 3, 0, dtype=d),
                        torch.ones(2, 1, 0, dtype=d)),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_bmv_source_on_host_matches_reference(host_card, case, dtype):
    gen = torch.Generator().manual_seed(sorted(CASES).index(case))
    X, Y = CASES[case](gen, DTYPES[dtype])
    before = kernels.bmv.launches
    got = kernels.bmv(X, Y)
    ref = kernels.bmv_reference(X, Y)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.is_contiguous()
    if X.shape[-1] == 0:
        assert kernels.bmv.launches == before and not got.any()
        return
    assert kernels.bmv.launches == before + 1
    assert bmv_err(got, ref, X, Y) <= 1.0


# (id, operands of the leading b of 8 scenarios): the scenario axis first
INVARIANCE = {
    "shared-matrix-warp-path": lambda M, v, b: (M[0, :4, :40],
                                                v[:b, :, :40]),
    "shared-vector": lambda M, v, b: (M[:b, :6, :12], v[0, :, :12]),
    "transposed-view": lambda M, v, b: (M[:b, :40, :5].mT, v[:b, :, :40]),
    "strided-rows": lambda M, v, b: (M[:b, ::3, 1:36], v[:b, :, :35]),
    "matmul-nt": lambda M, v, b: (M[:b, :3, :20], M[:b, 4:6, 20:40]),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(INVARIANCE))
def test_bmv_source_on_host_gives_a_scenario_its_bits_at_any_batch(
        host_card, case, dtype):
    """The leading scenarios' results at batches 1 and 3 are batch 8's, bit
    for bit, for broadcast, transposed and non-contiguous operands."""
    gen = torch.Generator().manual_seed(3)
    M = _randn(gen, 8, 40, 40, dtype=DTYPES[dtype])
    v = _randn(gen, 8, 1, 40, dtype=DTYPES[dtype])
    take = INVARIANCE[case]
    full = kernels.bmv(*take(M, v, 8))
    assert full.shape[0] == 8
    for b in (1, 3):
        got = kernels.bmv(*take(M, v, b))
        assert got.shape[0] == b
        assert torch.equal(got, full[:b]), (case, b)


def _cross_mv(M):
    def fn(w):
        return torch.linalg.cross(w, kernels.bmv(M, w[..., None, :])[..., 0])
    return fn


def _cross_mv_plain(M):
    def fn(w):
        return torch.linalg.cross(w, (M @ w[..., None])[..., 0])
    return fn


def test_bmv_gradients_through_the_host_source(host_card):
    """``torch.autograd.gradcheck`` of both operands, a broadcast matrix
    included (float64: the kernel's product against finite differences)."""
    gen = torch.Generator().manual_seed(5)
    X = _randn(gen, 2, 3, 4, dtype=torch.float64).requires_grad_(True)
    Y = _randn(gen, 2, 1, 4, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(kernels.bmv, (X, Y))
    Xs = _randn(gen, 3, 3, dtype=torch.float64).requires_grad_(True)
    Ys = _randn(gen, 2, 2, 3, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(kernels.bmv, (Xs, Ys))


def test_bmv_under_vmap_and_jacfwd_through_the_host_source(host_card):
    """``srb.linearize``'s transforms (``vmap`` of ``jacfwd``, a shared
    [3, 3] matrix), reverse mode over them (the outer gradient), and
    ``jacrev``, each against the same function on ``@`` (float64)."""
    gen = torch.Generator().manual_seed(6)
    M = _randn(gen, 3, 3, dtype=torch.float64)
    W = _randn(gen, 4, 3, dtype=torch.float64)
    lin = torch.func.vmap(torch.func.jacfwd(_cross_mv(M)))
    lin_plain = torch.func.vmap(torch.func.jacfwd(_cross_mv_plain(M)))
    np.testing.assert_allclose(lin(W), lin_plain(W), rtol=0, atol=1e-12)
    Wg = W.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(lin(Wg).pow(2).sum(), Wg)
    Wg = W.clone().requires_grad_(True)
    (g_plain,) = torch.autograd.grad(lin_plain(Wg).pow(2).sum(), Wg)
    np.testing.assert_allclose(g, g_plain, rtol=0, atol=1e-11)
    np.testing.assert_allclose(torch.func.jacrev(_cross_mv(M))(W[0]),
                               torch.func.jacrev(_cross_mv_plain(M))(W[0]),
                               rtol=0, atol=1e-12)
