"""More than 32 equality rows: the plain sweep against Pallas interpret
mode, and the Schur stage (``rgemm``, ``chol_inverse``) with
``ipm_iter_handed_kernel`` on the host build and on the card."""
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu_torch.ops import kernels

from torch_kernel_common import (
    card, _sweep_state, _jax_sweep, _spd_batch, host_lib, host_card,
    _sweep_batch, _run_sweep, _sweep_M)


# ---------------------------------------------------------------------------
# More than 32 equality rows (the centroidal QP has p = 256): the Schur stage
# (rgemm, chol_inverse) before the iteration kernel's handed variant.
# ---------------------------------------------------------------------------


MANY_ROWS = dict(n=100, m=200, n_p=128, m_p=256)


@pytest.mark.parametrize("p", [40, 64])
def test_ipm_iter_reference_many_rows_matches_pallas_interpret(p):
    """The plain sweep at p = 40 and 64 against one interpret-mode Pallas
    sweep (which unrolls the p x p Cholesky at any p), exact refresh,
    float32: rtol 1e-4 / atol 1e-5, as at p = 12 above."""
    reg, tol = 50 * float(np.finfo(np.float32).eps), 1e-7
    st = _sweep_state(40 + p, p=p, **MANY_ROWS)
    T = [torch.tensor(a[None]) for a in st]
    H, q, A, b, G, h, ga, x, y, lam, s, Mi = T
    best = (x.clone(), y.clone(), lam.clone(), s.clone(),
            torch.tensor([np.inf], dtype=torch.float32))
    out = kernels.ipm_iter_reference(
        H, q, A, b, G, h, ga, x, y, lam, s, torch.tensor([False]),
        torch.tensor([0], dtype=torch.int32), best, Mi, False, reg=reg,
        tol=tol, refine_steps=1, ns_steps=2)
    ref = _jax_sweep(st, False, False, 0, np.inf, (st[7], st[8], st[9],
                                                   st[10]), reg, tol)
    for name, got, exp in zip(("x", "y", "lam", "s"), out[:4], ref[:4]):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(exp),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert bool(out[4][0]) == bool(ref[4])
    assert int(out[5][0]) == int(ref[5])


# p = 96 at n = 256: two 128-column groups of a matrix pass, and the
# handed kernel's fused pass over A covers a row in two 16-byte pieces a
# lane (the shape of the centroidal QP's n = 512 in small)
MANY_ROWS_WIDE = dict(n=200, m=200, n_p=256, m_p=256)


@pytest.mark.parametrize("p", [40, 64, 96])
def test_ipm_iter_source_on_host_many_rows(host_card, p):
    """The wrapper's CUDA branch at p = 40 and 64 (n = 128, m = 256) and
    p = 96 (n = 256, m = 256), with the Newton-Schulz refresh and with the
    exact sweep handed its M: the Schur stage (two rgemm launches, one
    chol_inverse) runs before the iteration kernel's handed variant, and
    the sweep agrees with ipm_iter_reference to rtol 1e-4 of each field's
    max (float32 rounding of the same math in another order; the handed
    kernel's KKT solves associate (A Mi) r where the plain version has
    A (Mi r)).  Before the Schur stage existed the wrapper refused
    p > 32."""
    T = _sweep_batch((50 + p, 51 + p), p=p,
                     **(MANY_ROWS if p < 96 else MANY_ROWS_WIDE))
    for do_ns, extra in ((True, {}), (False, {"M": _sweep_M(T)})):
        ref = _run_sweep(kernels.ipm_iter_reference, T, do_ns, **extra)
        before = kernels.launch_counts()
        got = _run_sweep(kernels.ipm_iter, T, do_ns, **extra)
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "gtwg": int(do_ns), "ipm_iter": 1, "gj_inverse": 0, "rgemm": 2,
            "chol_inverse": 1, "bmv": 0}
        for name, g_, r_ in zip(("x", "y", "lam", "s"), got[:4], ref[:4]):
            err = float((g_ - r_).abs().max() / r_.abs().max())
            assert err <= 1e-4, (name, do_ns, err)
        for g_, r_ in zip(got[6], ref[6]):
            assert float((g_ - r_).abs().max() / r_.abs().max()) <= 1e-4
        assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
        assert float((got[7] - ref[7]).abs().max()
                     / ref[7].abs().max()) <= 1e-4


@pytest.mark.parametrize("p", [40, 70, 32, 64, 33, 256])
def test_chol_inverse_source_on_host_matches_reference(host_card, p):
    """csrc/chol_inverse.cu (the upper triangle's 32 x 32 tiles, blocked
    Cholesky, the triangular inverse by blocks, X X^T by 4 x 4 tiles)
    against chol_inverse_unrolled at one panel (p = 32), two (64), one
    column into a second (33), ragged (40, 70: an identity padding, scalar
    stores at p = 70) and the centroidal QP's p = 256: 1e-5 of max|Si|
    (the same steps, the sums in another order; condition ~40), exactly
    symmetric, and only the upper rows read: a lower triangle of NaN
    changes nothing."""
    S = torch.tensor(_spd_batch(60 + p, 2, p, ridge=0.5))
    before = kernels.chol_inverse.launches
    X = kernels.chol_inverse(S)
    assert kernels.chol_inverse.launches == before + 1
    ref = kernels.chol_inverse_unrolled(S)
    assert float((X - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert torch.equal(X, X.mT)
    upper = torch.where(torch.ones(p, p).triu().bool(), S,
                        torch.tensor(float("nan")))
    assert torch.equal(kernels.chol_inverse(upper), X)
    assert float((S @ X - torch.eye(p)).abs().max()) < 1e-4


@pytest.mark.parametrize("p", [40, 96])
def test_ipm_iter_handed_kernel_on_host_takes_the_stage_a_mi(host_card, p):
    """The handed iteration kernel launched by itself (ipm_iter_launch with
    Si and AMi) on the Schur stage's A Mi and S^-1, exact sweep handed its
    M: ipm_iter_reference to rtol 1e-4 of each field's max, done and it
    equal; it reads A Mi, not A and Mi, in its KKT solves, so an A Mi that
    is off by a factor moves the step; a launch with Si and no AMi is
    refused."""
    shape = MANY_ROWS if p < 96 else MANY_ROWS_WIDE
    T = _sweep_batch((80 + p, 81 + p), p=p, **shape)
    H, q, A, b, G, h, ga, x, y, lam, s, Mi = T
    M = _sweep_M(T)
    reg, tol = 50 * float(np.finfo(np.float32).eps), 1e-7
    ref = _run_sweep(kernels.ipm_iter_reference, T, False, M=M)
    AMi, Si = kernels.schur_stage(A, Mi, max(reg, 1e-7))

    def launch(ami):
        st = [t.clone() for t in (x, y, lam, s, x, y, lam, s)]
        bm = torch.tensor([np.inf, 4.0], dtype=torch.float32)
        done = torch.tensor([0, 1], dtype=torch.int32)
        it = torch.tensor([0, 2], dtype=torch.int32)
        kernels.ipm_iter_launch(host_card, None, H, q, A, b, G, h, ga, M, Mi,
                                *st[:4], *st[4:], bm, done, it, reg=reg,
                                tol=tol, refine_steps=1, Si=Si, AMi=ami)
        return st[:4], done, it

    (xo, yo, lo, so), done, it = launch(AMi)
    for name, g_, r_ in zip(("x", "y", "lam", "s"), (xo, yo, lo, so),
                            ref[:4]):
        err = float((g_ - r_).abs().max() / r_.abs().max())
        assert err <= 1e-4, (name, err)
    assert torch.equal(done.bool(), ref[4]) and torch.equal(it, ref[5])
    off = launch(1.5 * AMi)[0][0]
    assert float((off - xo).abs().max() / xo.abs().max()) > 1e-3
    with pytest.raises(RuntimeError, match="ipm_iter"):
        kernels.ipm_iter_launch(host_card, None, H, q, A, b, G, h, ga, M, Mi,
                                x.clone(), y.clone(), lam.clone(), s.clone(),
                                x.clone(), y.clone(), lam.clone(), s.clone(),
                                torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32), reg=reg,
                                tol=tol, refine_steps=1, Si=Si)


@pytest.mark.parametrize("R,Cc,K", [(40, 128, 128), (64, 64, 128),
                                    (150, 70, 90)])
def test_rgemm_source_on_host_matches_reference(host_card, R, Cc, K):
    """The rectangular product at the Schur stage's shapes (A Mi:
    [p, n] x [n, n]; (A Mi) A^T: [p, n] x [n, p]) and ragged (scalar
    copies, two tile rows): 1e-6 of max|C|, the sum over k in order with
    FMA, the diagonal term where i == j."""
    rng = np.random.default_rng(R + Cc + K)
    A = torch.tensor(rng.standard_normal((2, R, K)), dtype=torch.float32)
    Bm = torch.tensor(rng.standard_normal((2, K, Cc)), dtype=torch.float32)
    before = kernels.rgemm.launches
    C = kernels.rgemm(A, Bm, diag=0.25)
    assert kernels.rgemm.launches == before + 1
    ref = kernels.rgemm_reference(A, Bm, 0.25)
    assert float((C - ref).abs().max() / ref.abs().max()) <= 1e-6


def test_schur_stage_wrappers_on_cpu_run_the_plain_version():
    """On CPU tensors rgemm, chol_inverse and schur_stage are their plain
    versions (what _iteration_math computes with chol_inverse_unrolled,
    and A Mi), and nothing is launched; a non-square S is refused."""
    rng = np.random.default_rng(61)
    A = torch.tensor(rng.standard_normal((2, 40, 64)))
    L = torch.tensor(rng.standard_normal((2, 64, 64)))
    Mi = L @ L.mT + 64 * torch.eye(64)
    before = kernels.launch_counts()
    AMi, Si = kernels.schur_stage(A, Mi, 1e-7)
    assert kernels.launch_counts() == before
    assert torch.equal(AMi, A @ Mi)
    S = A @ Mi @ A.mT + 1e-7 * torch.eye(40)
    assert torch.equal(Si, kernels.chol_inverse_unrolled(
        kernels.rgemm_reference(A @ Mi, A.mT.contiguous(), 1e-7)))
    np.testing.assert_allclose((S @ Si).numpy(), np.eye(40)[None].repeat(
        2, 0), atol=1e-9)
    with pytest.raises(ValueError, match="square"):
        kernels.chol_inverse(torch.zeros(2, 3, 4))


@pytest.mark.cuda
def test_schur_stage_kernels_match_reference_on_card(card):
    """chol_inverse at the centroidal QP's p = 256 and rgemm at its
    A Mi shape on the card against their plain versions: 1e-4 of max|Si|
    (condition ~40), 1e-5 of max|C|."""
    S = torch.tensor(_spd_batch(62, 4, 256, ridge=0.5), device=card)
    X = kernels.chol_inverse(S)
    torch.cuda.synchronize()
    ref = kernels.chol_inverse_unrolled(S)
    assert float((X - ref).abs().max() / ref.abs().max()) <= 1e-4
    g = torch.Generator(device=card).manual_seed(0)
    A = torch.randn(4, 256, 512, device=card, generator=g)
    Mi = torch.randn(4, 512, 512, device=card, generator=g)
    C = kernels.rgemm(A, Mi)
    torch.cuda.synchronize()
    ref = kernels.rgemm_reference(A, Mi)
    assert float((C - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("p", [40, 256])
def test_ipm_iter_many_rows_matches_reference_on_card(card, p):
    """The sweep with the Schur stage on the card (p = 40; p = 256 at
    n = 512, m = 1792, the centroidal QP's padded shape) against the plain
    version: 1e-3 of each iterate's max, as at p = 12."""
    shape = (MANY_ROWS if p == 40 else
             dict(n=472, m=1712, n_p=512, m_p=1792))
    T = [t.to(card) for t in _sweep_batch((70, 71), p=p, **shape)]
    for do_ns in (False, True):
        ref = _run_sweep(kernels.ipm_iter_reference, T, do_ns)
        got = _run_sweep(kernels.ipm_iter, T, do_ns)
        torch.cuda.synchronize()
        for g_, r_ in zip(got[:4], ref[:4]):
            assert float((g_ - r_).abs().max() / r_.abs().max()) <= 1e-3
        assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
