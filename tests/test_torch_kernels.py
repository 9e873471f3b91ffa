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
    for name in ("gtwg.cu", "ipm_iter.cu"):
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
