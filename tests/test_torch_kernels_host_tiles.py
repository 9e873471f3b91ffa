"""The host build of the redesigned ``gtwg`` and Newton-Schulz product
(ragged and mirrored 128-wide tiles, the 16-byte path) and of the sweep
handed its M, at the main path's widths."""
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu_torch.ops import kernels

from torch_kernel_common import (
    _gtwg_data, host_lib, host_card, _sweep_batch, _run_sweep, _flat, _sweep_M)


# ---------------------------------------------------------------------------
# The redesigned gtwg / Newton-Schulz product (symmetric 128-wide tiles, 16-byte
# staging) and the sweep handed its M, on the host build.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("from_ls", [False, True])
@pytest.mark.parametrize("n", [130, 70, 132, 260])
def test_gtwg_source_on_host_mirrored_ragged_tiles(host_card, n, from_ls):
    """Ragged m=300 with n = 130 and 70 (scalar copies: n % 4 != 0, two tiles
    and one), 132 (16-byte copies, a ragged mirrored tile) and 260 (three
    tile rows).  Against gtwg_reference at 1e-6 of max|M|: on and above the
    diagonal the kernel sums fmaf(g_ki w_k, g_kj, .) over k in order like
    the CPU product; below it writes the mirrored sum, one rounding per term
    away.  With a symmetric H the output is exactly symmetric; with any H it
    is fl(S + H) for the exactly symmetric S that H = 0 gives."""
    H, G, W = map(torch.tensor, _gtwg_data(30 + n, m=300, n=n))
    if from_ls:
        lam, s = W + 0.5, torch.flip(W, (-1,)) + 0.1
        Wref = torch.clamp(lam / s, 1e-3, 1e3)
        kw = dict(lam=lam, s=s, w_hi=1e3)
    else:
        Wref, kw = W, dict(W=W)
    before = kernels.gtwg.launches
    got = kernels.gtwg(H, G, **kw)
    S = kernels.gtwg(torch.zeros_like(H), G, **kw)
    Hs = H + H.mT
    sym = kernels.gtwg(Hs, G, reg=0.3, **kw)
    assert kernels.gtwg.launches == before + 3
    ref = kernels.gtwg_reference(H, G, Wref)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6
    assert torch.equal(S, S.mT)
    assert torch.equal(got, S + H)
    assert torch.equal(sym, sym.mT)
    ref_s = kernels.gtwg_reference(Hs, G, Wref, 0.3)
    assert float((sym - ref_s).abs().max() / ref_s.abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [256, 132])
def test_ns_gemm_source_on_host_16_byte_path(host_card, n):
    """The Newton-Schulz product through its launcher at n=256 (whole tiles)
    and n=132 (ragged, still 16-byte copies): both products of one step.
    1e-6 of max|C|: the kernel sums over k in order with FMA."""
    rng = np.random.default_rng(31)
    M, Mi = (torch.tensor(rng.standard_normal((2, n, n)) / np.sqrt(n),
                          dtype=torch.float32) for _ in range(2))
    T, X = torch.empty_like(M), torch.empty_like(M)
    kernels.ns_gemm_launch(host_card, None, M, Mi, T, -1.0, 2.0)
    kernels.ns_gemm_launch(host_card, None, Mi, T, X, 1.0, 0.0)
    ref_t = 2.0 * torch.eye(n) - M @ Mi
    assert float((T - ref_t).abs().max() / ref_t.abs().max()) <= 1e-6
    ref_x = Mi @ T
    assert float((X - ref_x).abs().max() / ref_x.abs().max()) <= 1e-6


@pytest.mark.parametrize("do_ns", [False, True])
def test_ipm_iter_reference_handed_M_is_bitwise_the_same(do_ns):
    """Plain path: the sweep handed the M that it would form itself returns
    the same bits (the wrapper on CPU tensors too)."""
    T = _sweep_batch((12, 13))
    M = _sweep_M(T)
    for fn in (kernels.ipm_iter_reference, kernels.ipm_iter):
        without = _run_sweep(fn, T, do_ns)
        handed = _run_sweep(fn, T, do_ns, M=M)
        for a, b in zip(_flat(handed), _flat(without)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("do_ns", [False, True])
def test_ipm_iter_source_on_host_handed_M_is_bitwise_the_same(host_card,
                                                              do_ns):
    """Host-built chain: with M handed in gtwg is not launched again and
    every output is bit for bit what the chain gives when it forms M."""
    T = _sweep_batch((14, 15))
    M = _sweep_M(T)
    before = (kernels.gtwg.launches, kernels.ipm_iter.launches)
    without = _run_sweep(kernels.ipm_iter, T, do_ns)
    mid = (kernels.gtwg.launches, kernels.ipm_iter.launches)
    handed = _run_sweep(kernels.ipm_iter, T, do_ns, M=M)
    after = (kernels.gtwg.launches, kernels.ipm_iter.launches)
    assert mid == (before[0] + 1, before[1] + 1)
    assert after == (mid[0], mid[1] + 1)
    for a, b in zip(_flat(handed), _flat(without)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="M "):
        _run_sweep(kernels.ipm_iter, T, do_ns, M=M[:, :64])


@pytest.mark.parametrize("shape", [
    dict(n=200, m=300, p=16, n_p=256, m_p=384),
    dict(n=300, m=200, p=7, n_p=384, m_p=256),
    dict(n=60, m=100, p=20, n_p=128, m_p=128),
    dict(n=116, m=616, p=28, n_p=128, m_p=640),
], ids=["n256_m384_p16", "n384_m256_p7", "n128_m128_p20", "n128_m640_p28"])
def test_ipm_iter_source_on_host_wide_shapes(host_card, shape):
    """The chain at the main path's n = 256 (a lane covers two 16-byte
    pieces of a row of G) and at n = 384 (the residual pass takes the
    columns in two rounds), p not a multiple of 4 and p above 16 (the wider
    instance of the A Mi product), and at the Adam biped's lane shape
    (n = 128: half a column block of the row sums, one 128-wide tile of M
    a problem; p = 28, just under the resident limit of 32), with the
    Newton-Schulz refresh: rtol 1e-4 of each field's max, float32 rounding
    of the same math in another order."""
    T = _sweep_batch((16, 17), **shape)
    ref = _run_sweep(kernels.ipm_iter_reference, T, True)
    got = _run_sweep(kernels.ipm_iter, T, True)
    for name, g_, r_ in zip(("x", "y", "lam", "s"), got[:4], ref[:4]):
        err = float((g_ - r_).abs().max() / r_.abs().max())
        assert err <= 1e-4, (name, err)
    assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
    assert float((got[7] - ref[7]).abs().max() / ref[7].abs().max()) <= 1e-4


def test_fused_solve_through_host_kernels_forms_M_once_per_sweep(host_lib,
                                                                 monkeypatch):
    """pdip.solve(use_pallas=True) with the host-built kernels inside: one
    gtwg launch and one ipm_iter launch per sweep, exact or not (an exact
    sweep hands its M on), and the solution of the plain fused path to rtol
    1e-3 / atol 1e-4, the bound tests/test_torch_pdip.py holds the fused
    path to (float32, the same sweeps in another order of summation)."""
    from bilevel_gait_gen_tpu_torch.ops import pdip
    rng = np.random.default_rng(18)
    n, m, p = 40, 60, 12
    L = rng.standard_normal((n, n))
    qp = [torch.tensor(a[None], dtype=torch.float32) for a in (
        L @ L.T + np.eye(n), rng.standard_normal(n),
        rng.standard_normal((p, n)), rng.standard_normal(p),
        rng.standard_normal((m, n)), rng.standard_normal(m) + 2.0)]
    kw = dict(iters=8, tol=1e-7, exact_every=3, use_pallas=True)
    plain = pdip.solve(*qp, **kw)
    monkeypatch.setattr(kernels, "build", lambda: host_lib)
    monkeypatch.setattr(kernels, "_stream", lambda: None)
    # the padded sweep operands take the kernels; the start point's small
    # tensors stay on the plain path
    monkeypatch.setattr(kernels, "_on_card",
                        lambda *ts: ts[0].shape[-1] % 128 == 0)
    before = (kernels.gtwg.launches, kernels.ipm_iter.launches)
    sol = pdip.solve(*qp, **kw)
    assert (kernels.gtwg.launches - before[0],
            kernels.ipm_iter.launches - before[1]) == (8, 8)
    assert int(sol.iters[0]) == int(plain.iters[0])
    np.testing.assert_allclose(sol.x.numpy(), plain.x.numpy(), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(sol.gap[0]), float(plain.gap[0]),
                               rtol=1e-2)
