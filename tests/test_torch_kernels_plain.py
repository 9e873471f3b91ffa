"""The port's kernels (ops/kernels.py), their plain versions: against the
Pallas kernels in interpret mode, the wrappers' CPU behaviour, and the CUDA
kernels themselves on the card (marked ``cuda``, skipped without one)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.ops import pallas_kernels as pk
from bilevel_gait_gen_tpu_torch.ops import kernels

from torch_kernel_common import (
    card, _gtwg_data, _sweep_state, _jax_sweep, _spd_batch, _padded_spd_batch)


def test_gtwg_reference_matches_pallas_interpret():
    """Ragged shape (m=300, n=130).  rtol 2e-4 / atol 2e-3, the bound of
    tests/test_pallas_kernels.py for the same kernel: float32 sums of 300
    products in another order."""
    H, G, W = _gtwg_data(0)
    ref = kernels.gtwg_reference(*map(torch.tensor, (H, G, W)))
    out = pk.gtwg(*map(jnp.asarray, (H, G, W)), block_n=128, block_k=256,
                  interpret=True)
    np.testing.assert_allclose(ref.numpy(), np.asarray(out), rtol=2e-4,
                               atol=2e-3)


def test_gtwg_wrapper_on_cpu_runs_the_plain_version():
    H, G, W = map(torch.tensor, _gtwg_data(1, m=40, n=24))
    before = kernels.gtwg.launches
    M = kernels.gtwg(H, G, W, reg=0.5)
    exp = kernels.gtwg_reference(H, G, W) + 0.5 * torch.eye(24)
    np.testing.assert_allclose(M.numpy(), exp.numpy(), rtol=1e-6, atol=1e-5)
    lam = torch.rand(2, 40) + 0.1
    s = torch.rand(2, 40) + 0.1
    M2 = kernels.gtwg(H, G, lam=lam, s=s, w_hi=1e3)
    exp2 = kernels.gtwg_reference(H, G, torch.clamp(lam / s, 1e-3, 1e3))
    np.testing.assert_array_equal(M2.numpy(), exp2.numpy())
    assert kernels.gtwg.launches == before      # nothing was launched


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor on another device is refused."""
    H = torch.empty(1, 8, 8, device="meta")
    G = torch.empty(1, 8, 8, device="meta")
    W = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.gtwg(H, G, W)
    with pytest.raises(ValueError, match="gtwg needs"):
        kernels.gtwg(torch.zeros(1, 8, 8), torch.zeros(1, 8, 8))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_unrolled_schur_inverse_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    L = rng.standard_normal((3, 16, 16))
    S = (L @ np.swapaxes(L, -1, -2) + 0.5 * np.eye(16)).astype(dtype)
    got = kernels.chol_inverse_unrolled(torch.tensor(S))
    ref = jax.vmap(pk._chol_inverse_unrolled)(jnp.asarray(S))
    tol = 1e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol * np.abs(np.asarray(ref)).max())


# the Adam biped's lane QPs (configs/adam_march.yaml, N = 20): n = 116,
# m = 616, p = 28, padded by pdip to [128, 640]
ADAM_LANES = dict(n=116, m=616, p=28, n_p=128, m_p=640)


@pytest.mark.parametrize("do_ns,shape", [
    pytest.param(False, {}, id="False"), pytest.param(True, {}, id="True"),
    pytest.param(False, ADAM_LANES, id="adam-n128_m640_p28-False"),
    pytest.param(True, ADAM_LANES, id="adam-n128_m640_p28-True")])
def test_ipm_iter_reference_matches_pallas_interpret(do_ns, shape):
    """One sweep of ipm_iter_reference against one interpret-mode Pallas
    sweep on the same padded state (float32, n = m = 128, p = 12; and at
    the Adam biped's lane shape [128, 640, p = 28]): rtol 1e-4 / atol 1e-5,
    float32 rounding of the same math in another order (the Newton-Schulz
    products amplify it most)."""
    reg, tol = 50 * float(np.finfo(np.float32).eps), 1e-7
    states = [_sweep_state(3, **shape), _sweep_state(4, **shape)]
    # problem 1 enters with a finite best merit and done set
    bmerits = [np.inf, 5.0]
    dones = [False, True]
    its = [0, 3]
    T = [torch.tensor(np.stack([st[i] for st in states])) for i in range(12)]
    H, q, A, b, G, h, ga, x, y, lam, s, Mi = T
    best = (x.clone(), y.clone(), lam.clone(), s.clone(),
            torch.tensor(bmerits, dtype=torch.float32))
    out = kernels.ipm_iter_reference(
        H, q, A, b, G, h, ga, x, y, lam, s, torch.tensor(dones),
        torch.tensor(its, dtype=torch.int32), best, Mi, do_ns, reg=reg,
        tol=tol, refine_steps=1, ns_steps=2)
    for k, st in enumerate(states):
        ref = _jax_sweep(st, do_ns, dones[k], its[k], bmerits[k],
                         (st[7], st[8], st[9], st[10]), reg, tol)
        for name, got, exp in zip(("x", "y", "lam", "s"), out[:4], ref[:4]):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(exp),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        assert bool(out[4][k]) == bool(ref[4])
        assert int(out[5][k]) == int(ref[5])
        for got, exp in zip(out[6], ref[6]):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(exp),
                                       rtol=1e-4, atol=1e-5)
        Mi_ref = np.asarray(ref[7])
        np.testing.assert_allclose(out[7][k].numpy(), Mi_ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(Mi_ref).max())


@pytest.mark.parametrize("B,n", [(3, 128), (2, 256)])
def test_gj_inverse_reference_matches_pallas_interpret(B, n):
    """The plain blocked Gauss-Jordan (w=128, the Pallas kernel's width)
    against the Pallas kernel in interpret mode, float32: the same
    arithmetic with the panel products summed in another order, held to
    1e-4 of max|X| elementwise (condition number ~40)."""
    M = _spd_batch(20, B, n)
    ref = np.asarray(pk.gj_inverse(jnp.asarray(M), interpret=True))
    got = kernels.gj_inverse_reference(torch.tensor(M), w=128).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    eye = np.eye(n, dtype=np.float32)
    assert np.abs(M @ got - eye).max() < 1e-4


@pytest.mark.parametrize("w", [32, 128, 64])
def test_gj_inverse_reference_block_widths_agree(w):
    """The block width changes rounding, not the function: every width
    (and the scalar form, which w=64 selects at n=160) inverts to a float64
    residual of 1e-11."""
    M = torch.tensor(_spd_batch(21, 2, 160 if w == 64 else 256, np.float64))
    X = kernels.gj_inverse_reference(M, w=w)
    eye = torch.eye(M.shape[-1], dtype=torch.float64)
    assert float((M @ X - eye).abs().max()) < 1e-11


def test_gj_inverse_floors_a_zero_pivot_and_goes_on():
    """|p| < 1e-30 becomes 1e-30, without a rescue: the result is huge but
    the elimination finishes, as in the Pallas kernel."""
    M = np.diag([2.0, 0.0, 4.0]).astype(np.float64)
    got = kernels.gj_inverse_reference(torch.tensor(M)[None])[0].numpy()
    ref = np.asarray(pk.gj_inverse(jnp.asarray(M), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert got[1, 1] > 9e29 and got[0, 0] == 0.5


def test_spd_inverse_f64_matches_pallas_and_is_exact():
    """n=160 (padded to 256 inside), float64: both packages reach a 1e-9
    residual (tests/test_pallas_kernels.py::test_spd_inverse_f64_exact) and
    agree to 1e-9 of max|X|."""
    M = _spd_batch(9, 1, 160, np.float64, ridge=0.05)[0]
    ref = np.asarray(pk.spd_inverse(jnp.asarray(M), interpret=True))
    got = kernels.spd_inverse(torch.tensor(M)).numpy()
    eye = np.eye(160)
    assert np.abs(M @ got - eye).max() < 1e-9
    assert np.abs(M @ ref - eye).max() < 1e-9
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize("wexp", [0.0, 1.0, 3.0, 4.0])
def test_spd_inverse_ipm_spectrum_matches_pallas(wexp):
    """The W-dominated matrices of
    tests/test_pallas_kernels.py::test_spd_inverse_ipm_spectrum_interpret
    (n=232, m=400, float32): the port's spd_inverse is finite and meets that
    test's residual bound r < 20 max(r_chol, 1e-6), and its residual is
    within a factor 3 of the Pallas spd_inverse's in interpret mode (both
    keep the best of ten guarded deflation steps; the iterates themselves
    differ by the conditioning times float32 rounding)."""
    from bilevel_gait_gen_tpu_torch.ops import pdip
    rng = np.random.default_rng(7)
    n, m = 232, 400
    Gm = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
    w = (10.0 ** rng.uniform(-wexp, wexp, m)).astype(np.float32)
    eye = np.eye(n, dtype=np.float32)
    M = eye + (Gm.T * w[None, :]) @ Gm + 1e-5 * eye
    got = kernels.spd_inverse(torch.tensor(M)).numpy()
    ref = np.asarray(pk.spd_inverse(jnp.asarray(M), interpret=True))
    Xc = pdip._chol_inverse(torch.tensor(M)).numpy()
    r, rj, rc = (np.abs(M @ X - eye).max() for X in (got, ref, Xc))
    assert np.isfinite(got).all()
    assert r < 20 * max(rc, 1e-6), (r, rc)
    assert r < 3 * rj + 1e-6, (r, rj)


def test_gj_wrappers_on_cpu_run_the_plain_version_without_cholesky():
    """On CPU tensors gj_inverse is gj_inverse_reference (no Cholesky
    fallback: an indefinite matrix, which the Cholesky marks NaN, is
    inverted), nothing is launched, and spd_inverse keeps shift and deflate
    as keywords."""
    M = torch.tensor(np.diag([1.0, -2.0, 4.0, 0.5]).astype(np.float32))[None]
    before = kernels.gj_inverse.launches
    X = kernels.gj_inverse(M)
    np.testing.assert_array_equal(
        X.numpy(), kernels.gj_inverse_reference(M).numpy())
    np.testing.assert_allclose(torch.diagonal(X[0]).numpy(),
                               [1.0, -0.5, 0.25, 2.0])
    S = torch.tensor(_spd_batch(22, 2, 24))
    raw = kernels.spd_inverse(S, shift=0.0, deflate=0)
    np.testing.assert_allclose(raw.numpy(), torch.linalg.inv(S).numpy(),
                               rtol=1e-4, atol=1e-5)
    shifted = kernels.spd_inverse(S, shift=1e-1, deflate=0)
    assert float((shifted - raw).abs().max()) > 1e-3
    assert kernels.gj_inverse.launches == before
    with pytest.raises(ValueError, match="square"):
        kernels.gj_inverse(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_valid,n", [(232, 256), (40, 128), (100, 128)])
@pytest.mark.parametrize("w", [32, 128])
def test_gj_inverse_reference_n_valid_equals_padded(w, n_valid, n, dtype):
    """gj_inverse_reference(M, w, n_valid=) on a matrix whose tail is
    (1 + shift) I is the padded computation bit for bit, leading block and
    tail: zeros multiply and add exactly, and a last block narrower than w
    is widened by a decoupled identity so that every product keeps its
    length."""
    M = _padded_spd_batch(28, 2, n, n_valid).to(
        torch.float32 if dtype is np.float32 else torch.float64)
    full = kernels.gj_inverse_reference(M, w=w)
    lead = kernels.gj_inverse_reference(M, w=w, n_valid=n_valid)
    assert torch.equal(full, lead)
    assert float(lead[0, n - 1, n - 1]) != 0.0
    assert torch.equal(kernels.gj_inverse(M, n_valid=n_valid),
                       kernels.gj_inverse_reference(M, n_valid=n_valid))
    with pytest.raises(ValueError, match="n_valid"):
        kernels.gj_inverse_reference(M[..., :n - 1, :n - 1], w=w, n_valid=8)


def _spd_inverse_uncarried(M, shift=1e-3, deflate=10):
    """spd_inverse as it was before Mp @ out was carried from one deflation
    step to the next: three products a step."""
    n = M.shape[-1]
    Mp, d = kernels.spd_scale_pad(M)
    eye_p = torch.eye(Mp.shape[-1], dtype=M.dtype)
    out = kernels.gj_inverse(Mp + shift * eye_p)

    def resid(X):
        return torch.amax(torch.abs(Mp @ X - eye_p), dim=(-2, -1))

    r_best = resid(out)
    for _ in range(deflate):
        cand = out @ (2.0 * eye_p - Mp @ out)
        r = resid(cand)
        fin = torch.isfinite(r)
        take = (r < r_best) & fin
        out = torch.where(take[..., None, None], cand, out)
        r_best = torch.minimum(r_best, torch.where(fin, r, r_best))
    out = out[..., :n, :n]
    return out * d[..., :, None] * d[..., None, :]


@pytest.mark.parametrize("wexp", [0.0, 1.0, 3.0, 4.0])
def test_spd_inverse_carried_product_is_bitwise_the_same(wexp):
    """The IPM spectra of test_spd_inverse_ipm_spectrum_matches_pallas as a
    batch of two (so that one matrix keeps a candidate where the other does
    not): carrying Mp @ out along the deflation, and telling gj_inverse where
    the padding starts, changes no bit of the result."""
    rng = np.random.default_rng(7)
    n, m = 232, 400
    Ms = []
    for scale in (1.0, 0.25):
        Gm = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
        w = (10.0 ** rng.uniform(-wexp * scale, wexp, m)).astype(np.float32)
        eye = np.eye(n, dtype=np.float32)
        Ms.append(eye + (Gm.T * w[None, :]) @ Gm + 1e-5 * eye)
    M = torch.tensor(np.stack(Ms))
    assert torch.equal(kernels.spd_inverse(M), _spd_inverse_uncarried(M))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 232])
def test_gj_inverse_kernel_matches_reference_on_card(card, n):
    """Blocked form (n=256) and scalar form (n=232) on the card against the
    plain version at the kernel's block width, 1e-4 of max|X|."""
    M = torch.tensor(_spd_batch(23, 4, n), device=card)
    before = kernels.gj_inverse.launches
    X = kernels.gj_inverse(M)
    torch.cuda.synchronize()
    assert kernels.gj_inverse.launches == before + 1
    ref = kernels.gj_inverse_reference(M, w=kernels.GJ_BLOCK)
    assert float((X - ref).abs().max() / ref.abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="float32"):
        kernels.gj_inverse(M.double())


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [232, 256])
def test_gj_inverse_forms_match_reference_on_card(card, n_valid):
    """[256, 256] with a shifted identity from n_valid on: the resident form
    (n_valid=232) and the streaming form (256) against the plain version at
    the kernel's block width, 1e-4 of max|X|; the tail bit for bit."""
    M = _padded_spd_batch(29, 4, 256, n_valid).to(card)
    X = kernels.gj_inverse(M, n_valid=n_valid)
    torch.cuda.synchronize()
    ref = kernels.gj_inverse_reference(M, w=kernels.GJ_BLOCK)
    assert float((X - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert torch.equal(X[:, n_valid:], ref[:, n_valid:])


@pytest.mark.cuda
def test_gtwg_kernel_matches_reference_on_card(card):
    H, G, W = (torch.tensor(a, device=card) for a in _gtwg_data(5))
    before = kernels.gtwg.launches
    M = kernels.gtwg(H, G, W, reg=0.25)
    torch.cuda.synchronize()
    ref = kernels.gtwg_reference(H, G, W, 0.25)
    assert kernels.gtwg.launches == before + 1
    assert float((M - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("do_ns", [False, True])
def test_ipm_iter_kernel_matches_reference_on_card(card, do_ns):
    reg, tol = 50 * float(np.finfo(np.float32).eps), 1e-7
    states = [_sweep_state(6), _sweep_state(7)]
    T = [torch.tensor(np.stack([st[i] for st in states]), device=card)
         for i in range(12)]
    H, q, A, b, G, h, ga, x, y, lam, s, Mi = T
    done = torch.zeros(2, dtype=torch.bool, device=card)
    it = torch.zeros(2, dtype=torch.int32, device=card)

    def best():
        return (x.clone(), y.clone(), lam.clone(), s.clone(),
                torch.full((2,), float("inf"), device=card))

    ref = kernels.ipm_iter_reference(H, q, A, b, G, h, ga, x, y, lam, s,
                                     done, it, best(), Mi, do_ns, reg=reg,
                                     tol=tol, refine_steps=1, ns_steps=2)
    got = kernels.ipm_iter(H, q, A, b, G, h, ga, x.clone(), y.clone(),
                           lam.clone(), s.clone(), done, it.clone(), best(),
                           Mi, do_ns, reg=reg, tol=tol, refine_steps=1,
                           ns_steps=2)
    torch.cuda.synchronize()
    for g, r in zip(got[:4], ref[:4]):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-3
    assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
