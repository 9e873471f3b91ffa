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


@pytest.mark.parametrize("do_ns", [False, True])
def test_ipm_iter_reference_matches_pallas_interpret(do_ns):
    """One sweep of ipm_iter_reference against one interpret-mode Pallas
    sweep on the same padded state (float32, n = m = 128, p = 12): rtol
    1e-4 / atol 1e-5, float32 rounding of the same math in another order
    (the Newton-Schulz products amplify it most)."""
    reg, tol = 50 * float(np.finfo(np.float32).eps), 1e-7
    states = [_sweep_state(3), _sweep_state(4)]
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
    for name in ("gtwg.cu", "ipm_iter.cu", "gj_inverse.cu"):
        src = (kernels.CSRC / name).read_text()
        src = src.replace('#include "common.cuh"', "")
        src = re.sub(r"([\w:]+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ",
                     src)
        src = src.replace("extern __shared__ float smem[];",
                          "float* smem = emu_dyn;")
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
                               70, -1.0, 2.0, None) == 0
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


@pytest.mark.parametrize("n", [64, 96, 40])
def test_gj_inverse_source_on_host_matches_reference(host_card, n):
    """csrc/gj_inverse.cu through ops/kernels.py::gj_inverse: the blocked
    form (n=64, 96: two and three 32-wide blocks) and the scalar form
    (n=40) against the plain version at the kernel's block width.  The
    scalar elimination rounds product and difference separately on both
    sides; the panel products sum in another order: 1e-5 of max|X|."""
    M = torch.tensor(_spd_batch(24, 2, n, ridge=1.0))
    before = kernels.gj_inverse.launches
    X = kernels.gj_inverse(M)
    assert kernels.gj_inverse.launches == before + 1
    ref = kernels.gj_inverse_reference(M, w=kernels.GJ_BLOCK)
    assert float((X - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float((M @ X - torch.eye(n)).abs().max()) < 1e-4
    assert host_card.bggt_gj_block_width() == kernels.GJ_BLOCK


def test_spd_inverse_through_host_kernel(host_card):
    """spd_inverse whole with the host-compiled kernel inside (n=40 padded
    to 128): residual 1e-4 in float32."""
    M = torch.tensor(_spd_batch(25, 2, 40))
    before = kernels.gj_inverse.launches
    X = kernels.spd_inverse(M)
    assert kernels.gj_inverse.launches == before + 1
    assert float((M @ X - torch.eye(40)).abs().max()) < 1e-4
