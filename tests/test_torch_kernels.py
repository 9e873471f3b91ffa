"""The port's kernels (ops/kernels.py): their plain PyTorch versions against
the Pallas kernels in interpret mode, the wrappers' CPU behaviour, and the
CUDA kernels themselves, which run only with a card (marked ``cuda``)."""
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.ops import pallas_kernels as pk
from bilevel_gait_gen_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _gtwg_data(seed, B=2, m=300, n=130):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, n)).astype(np.float32),
            rng.standard_normal((B, m, n)).astype(np.float32),
            np.abs(rng.standard_normal((B, m))).astype(np.float32))


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


def _sweep_state(seed, n=40, m=60, p=12, n_p=128, m_p=128):
    """A padded interior-point state of one random QP (float32 numpy):
    unit H diagonal and zero G rows with h = 1 on the padding, slacks and
    duals strictly interior, Mi an inverse of M at a nearby W."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    H = np.eye(n_p)
    H[:n, :n] = (L @ L.T + np.eye(n)) / n
    q = np.zeros(n_p)
    q[:n] = rng.standard_normal(n)
    A = np.zeros((p, n_p))
    A[:, :n] = rng.standard_normal((p, n)) / np.sqrt(n)
    b = rng.standard_normal(p)
    G = np.zeros((m_p, n_p))
    G[:m, :n] = rng.standard_normal((m, n)) / np.sqrt(n)
    h = np.ones(m_p)
    h[:m] = rng.standard_normal(m) + 2.0
    ga = np.any(G != 0, axis=-1).astype(np.float64)
    x = np.zeros(n_p)
    x[:n] = 0.1 * rng.standard_normal(n)
    y = 0.1 * rng.standard_normal(p)
    s = np.where(ga > 0, np.maximum(h - G @ x, 0.3), 1.0)
    lam = np.where(ga > 0, (1.0 + np.abs(q).max() / n_p) / s, 1e-6)
    W_near = np.clip(lam / s * (1.0 + 0.05 * rng.standard_normal(m_p)),
                     1e-6, 1e6)
    Mi = np.linalg.inv(H + (G.T * W_near) @ G + 1e-6 * np.eye(n_p))
    f = np.float32
    return [a.astype(f) for a in (H, q, A, b, G, h, ga, x, y, lam, s, Mi)]


def _jax_sweep(st, do_ns, done, it, bmerit, best, reg, tol):
    H, q, A, b, G, h, ga, x, y, lam, s, Mi = map(jnp.asarray, st)
    best_j = tuple(map(jnp.asarray, best)) + (jnp.float32(bmerit),)
    return pk.ipm_iter(H, q, A, b, G, h, ga, x, y, lam, s,
                       jnp.asarray(done), jnp.asarray(it, jnp.int32), best_j,
                       Mi, jnp.float32(do_ns), reg=reg, tol=tol,
                       refine_steps=1, ns_steps=2, interpret=True)


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


def _spd_batch(seed, B, n, dtype=np.float32, ridge=0.1):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, n, n)) / np.sqrt(n)
    return (L @ np.swapaxes(L, -1, -2) + ridge * np.eye(n)).astype(dtype)


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


# ---------------------------------------------------------------------------
# The CUDA sources compiled for the host (csrc/host_emulation.h): the
# kernels' own arithmetic, indexing and barriers, run on CPU tensors
# through the wrappers' CUDA branch.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    parts = [(kernels.CSRC / "common.cuh").read_text().replace(
        "#include <cuda_runtime.h>", '#include "host_emulation.h"')]
    for name in (n for n in kernels._SOURCES if n.endswith(".cu")):
        src = (kernels.CSRC / name).read_text()
        src = src.replace('#include "common.cuh"', "")
        src = re.sub(r"([\w:]+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ",
                     src)
        src = re.sub(r"extern __shared__ (?:__align__\(16\) )?float smem\[\];",
                     "float* smem = emu_dyn;", src)
        parts.append(src)
    out = tmp_path_factory.mktemp("host_kernels")
    cpp = out / "kernels_host.cpp"
    cpp.write_text("\n".join(p.replace("#pragma once", "") for p in parts))
    lib_path = out / "libbggt_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-I", str(kernels.CSRC), "-o", str(lib_path),
                    str(cpp)], check=True, capture_output=True, timeout=300)
    return kernels.bind(lib_path), lib_path


@pytest.fixture
def host_card(host_lib, monkeypatch):
    """Route the wrappers' CUDA branch to the host-compiled kernels."""
    monkeypatch.setattr(kernels, "build", lambda: host_lib)
    monkeypatch.setattr(kernels, "_stream", lambda: None)
    monkeypatch.setattr(kernels, "_on_card", lambda *ts: True)
    return host_lib[0]


@pytest.mark.parametrize("from_ls", [False, True])
def test_gtwg_source_on_host_matches_reference(host_card, from_ls):
    """Ragged shape; the kernel accumulates each entry over the rows of G in
    order with FMA, as the CPU matmul does: agreement to rounding (rtol
    1e-6 of max|M|)."""
    H, G, W = map(torch.tensor, _gtwg_data(8))
    before = kernels.gtwg.launches
    if from_ls:
        lam, s = W + 0.5, torch.flip(W, (-1,)) + 0.1
        got = kernels.gtwg(H, G, lam=lam, s=s, w_hi=1e3, reg=0.3)
        ref = kernels.gtwg_reference(H, G, torch.clamp(lam / s, 1e-3, 1e3),
                                     0.3)
    else:
        got = kernels.gtwg(H, G, W)
        ref = kernels.gtwg_reference(H, G, W)
    assert kernels.gtwg.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6


def test_ns_gemm_source_on_host(host_card):
    rng = np.random.default_rng(9)
    A, Bm = (torch.tensor(rng.standard_normal((2, 70, 70)),
                          dtype=torch.float32) for _ in range(2))
    C = torch.empty_like(A)
    assert host_card.bggt_gemm(A.data_ptr(), Bm.data_ptr(), C.data_ptr(), 2,
                               70, -1.0, 2.0, 0, None) == 0
    ref = 2.0 * torch.eye(70) - A @ Bm
    assert float((C - ref).abs().max() / ref.abs().max()) <= 1e-6


@pytest.mark.parametrize("do_ns", [False, True])
def test_ipm_iter_source_on_host_matches_reference(host_card, do_ns):
    """The whole kernel chain (gtwg, Newton-Schulz GEMMs, iteration kernel)
    through ops/kernels.py::ipm_iter against ipm_iter_reference, one sweep
    from the same state.  rtol 1e-4 of each field's max: float32 rounding
    of the same math in another order."""
    reg, tol = 50 * float(np.finfo(np.float32).eps), 1e-7
    states = [_sweep_state(10), _sweep_state(11)]
    T = [torch.tensor(np.stack([st[i] for st in states])) for i in range(12)]
    H, q, A, b, G, h, ga, x, y, lam, s, Mi = T
    done = torch.tensor([False, True])
    it = torch.tensor([0, 2], dtype=torch.int32)

    def best():
        return (x.clone(), y.clone(), lam.clone(), s.clone(),
                torch.tensor([np.inf, 4.0], dtype=torch.float32))

    ref = kernels.ipm_iter_reference(H, q, A, b, G, h, ga, x, y, lam, s,
                                     done, it, best(), Mi, do_ns, reg=reg,
                                     tol=tol, refine_steps=1, ns_steps=2)
    before = (kernels.gtwg.launches, kernels.ipm_iter.launches)
    got = kernels.ipm_iter(H, q, A, b, G, h, ga, x.clone(), y.clone(),
                           lam.clone(), s.clone(), done, it.clone(), best(),
                           Mi, do_ns, reg=reg, tol=tol, refine_steps=1,
                           ns_steps=2)
    assert (kernels.gtwg.launches, kernels.ipm_iter.launches) == (
        before[0] + 1, before[1] + 1)
    for name, g_, r_ in zip(("x", "y", "lam", "s"), got[:4], ref[:4]):
        err = float((g_ - r_).abs().max() / r_.abs().max())
        assert err <= 1e-4, (name, err)
    for g_, r_ in zip(got[6], ref[6]):
        assert float((g_ - r_).abs().max() / r_.abs().max()) <= 1e-4
    assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
    assert float((got[7] - ref[7]).abs().max() / ref[7].abs().max()) <= 1e-4


def _padded_spd_batch(seed, B, n, n_valid, shift=1e-3):
    """What spd_inverse hands to gj_inverse: an SPD leading block of
    n_valid rows, an identity tail, the shift on all of the diagonal."""
    M = np.zeros((B, n, n), np.float32)
    M[:, :n_valid, :n_valid] = _spd_batch(seed, B, n_valid, ridge=1.0)
    M[:, range(n_valid, n), range(n_valid, n)] = 1.0
    return torch.tensor(M + np.float32(shift) * np.eye(n, dtype=np.float32))


@pytest.mark.parametrize("n,n_valid", [
    pytest.param(64, None, id="64"), pytest.param(96, None, id="96"),
    pytest.param(40, None, id="40"),
    pytest.param(64, 40, id="64-straddling-last-block"),
    pytest.param(96, 36, id="96-valid-not-multiple-of-8"),
    pytest.param(96, 64, id="96-tail-is-a-whole-block"),
    pytest.param(64, 64, id="64-no-tail")])
def test_gj_inverse_source_on_host_matches_reference(host_card, n, n_valid):
    """csrc/gj_inverse.cu through ops/kernels.py::gj_inverse: the blocked
    form (n=64, 96: two and three 32-wide blocks, resident in shared memory
    at these sizes) and the scalar form (n=40) against the plain version at
    the kernel's block width.  The scalar elimination rounds product and
    difference separately on both sides; the panel products sum in another
    order: 1e-5 of max|X|.  With ``n_valid`` (a shifted identity from there
    on: a last block that straddles the tail, a valid size that is no
    multiple of 8, a tail of a whole block, no tail) the result is that of
    the padded computation, the tail's diagonal bit for bit."""
    if n_valid is None:
        M = torch.tensor(_spd_batch(24, 2, n, ridge=1.0))
    else:
        M = _padded_spd_batch(24, 2, n, n_valid)
    form = kernels.gj_form(host_card, n, n_valid or n)
    assert form == ("scalar" if n == 40 else "resident")
    before = (kernels.gj_inverse.launches,
              kernels.gj_inverse.launches_by_form[form])
    X = kernels.gj_inverse(M, n_valid=n_valid)
    assert (kernels.gj_inverse.launches,
            kernels.gj_inverse.launches_by_form[form]) == (
        before[0] + 1, before[1] + 1)
    ref = kernels.gj_inverse_reference(M, w=kernels.GJ_BLOCK)
    assert float((X - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float((M @ X - torch.eye(n)).abs().max()) < 1e-4
    assert host_card.bggt_gj_block_width() == kernels.GJ_BLOCK
    if n_valid is not None:
        assert torch.equal(X[:, n_valid:], ref[:, n_valid:])
        assert torch.equal(X[:, :, n_valid:], ref[:, :, n_valid:])


@pytest.mark.parametrize("n", [64, 96])
def test_gj_inverse_streaming_source_on_host(host_card, n):
    """The streaming form (the one a [256, 256] matrix takes on the card,
    too large for a block's shared memory) launched by name at small sizes:
    the same block steps on staged panels, 1e-5 of max|X| from the plain
    version at the kernel's block width; the wrapper picks it by shape."""
    M = torch.tensor(_spd_batch(26, 2, n, ridge=1.0))
    X = torch.empty_like(M)
    kernels.gj_launch(host_card, None, M, X, n, "streaming")
    ref = kernels.gj_inverse_reference(M, w=kernels.GJ_BLOCK)
    assert float((X - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert kernels.gj_form(host_card, 256, 232) == "resident"
    assert kernels.gj_form(host_card, 256, 233) == "streaming"
    assert kernels.gj_form(host_card, 256, 256) == "streaming"
    with pytest.raises(ValueError, match="shared memory"):
        kernels.gj_form(host_card, 1024, 1024)


def test_spd_inverse_through_host_kernel(host_card):
    """spd_inverse whole with the host-compiled kernel inside (n=40 padded
    to 128): residual 1e-4 in float32."""
    M = torch.tensor(_spd_batch(25, 2, 40))
    before = kernels.gj_inverse.launches
    X = kernels.spd_inverse(M)
    assert kernels.gj_inverse.launches == before + 1
    assert float((M @ X - torch.eye(40)).abs().max()) < 1e-4


def test_spd_inverse_through_host_kernel_matches_pallas(host_card):
    """spd_inverse with the host-compiled resident kernel inside (n=40, told
    that the padding starts at 40) against the JAX package's spd_inverse in
    interpret mode: both deflate to the float32 floor of a matrix of
    condition ~40, 1e-4 of max|X| apart at most."""
    M = _spd_batch(27, 2, 40)
    got = kernels.spd_inverse(torch.tensor(M)).numpy()
    ref = np.asarray(pk.spd_inverse(jnp.asarray(M), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


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


def _sweep_batch(seeds, **shape):
    states = [_sweep_state(sd, **shape) for sd in seeds]
    return [torch.tensor(np.stack([st[i] for st in states]))
            for i in range(12)]


def _run_sweep(fn, T, do_ns, **extra):
    """One sweep of ``fn`` (ipm_iter or its plain version) from fresh copies
    of the state T; problem 1 enters done with a finite best merit."""
    H, q, A, b, G, h, ga, x, y, lam, s, Mi = T
    reg, tol = 50 * float(np.finfo(np.float32).eps), 1e-7
    best = (x.clone(), y.clone(), lam.clone(), s.clone(),
            torch.tensor([np.inf, 4.0], dtype=torch.float32))
    return fn(H, q, A, b, G, h, ga, x.clone(), y.clone(), lam.clone(),
              s.clone(), torch.tensor([False, True]),
              torch.tensor([0, 2], dtype=torch.int32), best, Mi, do_ns,
              reg=reg, tol=tol, refine_steps=1, ns_steps=2, **extra)


def _flat(out):
    return [*out[:6], *out[6], out[7]]


def _sweep_M(T):
    """The M of the sweep from state T, as pdip forms it for the Cholesky."""
    eps = float(np.finfo(np.float32).eps)
    return kernels.gtwg(T[0], T[4], lam=T[9], s=T[10], w_hi=0.01 / eps,
                        reg=50 * eps)


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


@pytest.mark.parametrize("p", [40, 64])
def test_ipm_iter_source_on_host_many_rows(host_card, p):
    """The wrapper's CUDA branch at p = 40 and 64 (n = 128, m = 256), with
    the Newton-Schulz refresh and with the exact sweep handed its M: the
    Schur stage (two rgemm launches, one chol_inverse) runs before the
    iteration kernel's handed variant, and the sweep agrees with
    ipm_iter_reference to rtol 1e-4 of each field's max (float32 rounding
    of the same math in another order).  Before the Schur stage existed
    the wrapper refused p > 32."""
    T = _sweep_batch((50 + p, 51 + p), p=p, **MANY_ROWS)
    for do_ns, extra in ((True, {}), (False, {"M": _sweep_M(T)})):
        ref = _run_sweep(kernels.ipm_iter_reference, T, do_ns, **extra)
        before = kernels.launch_counts()
        got = _run_sweep(kernels.ipm_iter, T, do_ns, **extra)
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "gtwg": int(do_ns), "ipm_iter": 1, "gj_inverse": 0, "rgemm": 2,
            "chol_inverse": 1}
        for name, g_, r_ in zip(("x", "y", "lam", "s"), got[:4], ref[:4]):
            err = float((g_ - r_).abs().max() / r_.abs().max())
            assert err <= 1e-4, (name, do_ns, err)
        for g_, r_ in zip(got[6], ref[6]):
            assert float((g_ - r_).abs().max() / r_.abs().max()) <= 1e-4
        assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
        assert float((got[7] - ref[7]).abs().max()
                     / ref[7].abs().max()) <= 1e-4


@pytest.mark.parametrize("p", [40, 70])
def test_chol_inverse_source_on_host_matches_reference(host_card, p):
    """csrc/chol_inverse.cu (packed upper triangle, right-looking steps,
    the triangular inverse in place, X X^T by 4 x 4 tiles, p = 70 ragged)
    against chol_inverse_unrolled: 1e-5 of max|Si| (the same steps, the
    sums in another order; condition ~40), exactly symmetric, and only the
    upper rows read: a lower triangle of NaN changes nothing."""
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
    """On CPU tensors rgemm, chol_inverse and schur_inverse are their plain
    versions (what _iteration_math computes with chol_inverse_unrolled),
    and nothing is launched; a non-square S is refused."""
    rng = np.random.default_rng(61)
    A = torch.tensor(rng.standard_normal((2, 40, 64)))
    L = torch.tensor(rng.standard_normal((2, 64, 64)))
    Mi = L @ L.mT + 64 * torch.eye(64)
    before = kernels.launch_counts()
    Si = kernels.schur_inverse(A, Mi, 1e-7)
    assert kernels.launch_counts() == before
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
