"""``csrc/bmv.cu`` compiled for the host (``torch_kernel_common.host_lib``)
through ``kernels.bmv``'s CUDA branch on CPU tensors.

* against the exact model of its arithmetic contract
  (``kernel_checks.bmv_exact``: every product, FMA and butterfly add of the
  contract's order in ``fractions.Fraction``, rounded once to the dtype,
  ties to even), bit for bit, in float32 and float64, on both of its paths
  (one FMA chain an entry up to K = 32, 32 lane chains and a butterfly past
  it), broadcast, transposed and strided operands, more batch axes than the
  kernel addresses, more rows than one block's tile and a sum longer than
  one staged chunk of k;
* against its plain version (``kernels.bmv_reference``) on the same cases:
  each entry within K eps of its sum_k |X_k Y_k| (``kernel_checks.bmv_err``
  <= 1, the first-order bound of two orders of summation);
* a scenario's bits at batches 1, 3 and 8: the property the kernel exists
  for (the card's cuBLAS GEMV gave a scenario other bits at another batch);
* its autograd rules (``kernels._Bmv``): gradients, ``jacfwd`` under
  ``vmap`` and reverse mode over that, as ``srb.linearize`` and the outer
  gradient take them, against the same functions on ``@``.

Shapes are small: an emulated launch runs a fiber per CUDA thread, and the
exact model takes tens of microseconds a term.
"""
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu_torch.ops import kernels
from bilevel_gait_gen_tpu_torch.ops.kernel_checks import (bmv_err,
                                                          bmv_exact)

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

# more lengths and tiles for the exact model (seeded apart from CASES)
EXTRA_CASES = {
    "matvec-k31": lambda g, d: (_randn(g, 2, 6, 31, dtype=d),
                                _randn(g, 2, 1, 31, dtype=d)),
    "matvec-transposed-view-k12": lambda g, d: (
        _randn(g, 2, 12, 18, dtype=d).mT, _randn(g, 2, 1, 12, dtype=d)),
    "matvec-warp-k64": lambda g, d: (_randn(g, 2, 5, 64, dtype=d),
                                     _randn(g, 2, 1, 64, dtype=d)),
    "matmul-nt-k120": lambda g, d: (_randn(g, 2, 5, 120, dtype=d),
                                    _randn(g, 2, 4, 120, dtype=d)),
    # more rows than one block's tile (32 rows a block at K = 40 in a
    # matvec, 64 at K <= 32)
    "rows-past-one-tile-k40": lambda g, d: (_randn(g, 1, 70, 40, dtype=d),
                                            _randn(g, 1, 1, 40, dtype=d)),
    "rows-past-one-tile-k5": lambda g, d: (_randn(g, 1, 130, 5, dtype=d),
                                           _randn(g, 1, 1, 5, dtype=d)),
    # a sum of many staged chunks of k, two buffers deep, over 9 rows, more
    # than one tile
    "chunks-of-k-2500": lambda g, d: (_randn(g, 1, 9, 2500, dtype=d),
                                      _randn(g, 1, 1, 2500, dtype=d)),
    # small X Y^T on the one-thread path past 32 terms
    "small-matmul-nt-k40": lambda g, d: (_randn(g, 3, 1, 40, dtype=d),
                                         _randn(g, 3, 2, 40, dtype=d)),
    "small-matmul-nt-k64": lambda g, d: (_randn(g, 3, 2, 64, dtype=d),
                                         _randn(g, 3, 2, 64, dtype=d)),
    "wide-matmul-nt-k64": lambda g, d: (_randn(g, 1, 16, 64, dtype=d),
                                        _randn(g, 1, 128, 64, dtype=d)),
    # tiles whose two 32-column buffers would pass the shared memory a block
    # may take (64 scenarios of 1 + 2 rows in float32; 32 of 2 + 2 rows and
    # 16 + 128 rows in float64): the block holds fewer scenarios or rows
    "small-matmul-nt-k70": lambda g, d: (_randn(g, 3, 1, 70, dtype=d),
                                         _randn(g, 3, 2, 70, dtype=d)),
    "small-square-matmul-nt-k70": lambda g, d: (
        _randn(g, 3, 2, 70, dtype=d), _randn(g, 3, 2, 70, dtype=d)),
    "wide-matmul-nt-k70": lambda g, d: (_randn(g, 1, 16, 70, dtype=d),
                                        _randn(g, 1, 128, 70, dtype=d)),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES) + list(EXTRA_CASES))
def test_bmv_source_on_host_matches_reference(host_card, case, dtype):
    if case in CASES:
        seed, make = sorted(CASES).index(case), CASES[case]
    else:
        seed, make = 100 + list(EXTRA_CASES).index(case), EXTRA_CASES[case]
    X, Y = make(torch.Generator().manual_seed(seed), DTYPES[dtype])
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
    exact = bmv_exact(X, Y)
    assert torch.equal(got, exact) and torch.equal(
        torch.signbit(got), torch.signbit(exact)), (
        case, dtype, int((got != exact).sum()))


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
