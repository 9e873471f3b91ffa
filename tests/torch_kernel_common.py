"""What the four ``test_torch_kernels_*`` files share: the ``card`` fixture,
the host build of the CUDA sources (``host_lib``, ``host_card``) and the
seeded inputs of the kernels' tests."""
import re
import shutil
import subprocess

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


def _spd_batch(seed, B, n, dtype=np.float32, ridge=0.1):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, n, n)) / np.sqrt(n)
    return (L @ np.swapaxes(L, -1, -2) + ridge * np.eye(n)).astype(dtype)


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
    monkeypatch.setattr(kernels, "_on_card", lambda *ts, **kw: True)
    return host_lib[0]


def _padded_spd_batch(seed, B, n, n_valid, shift=1e-3):
    """What spd_inverse hands to gj_inverse: an SPD leading block of
    n_valid rows, an identity tail, the shift on all of the diagonal."""
    M = np.zeros((B, n, n), np.float32)
    M[:, :n_valid, :n_valid] = _spd_batch(seed, B, n_valid, ridge=1.0)
    M[:, range(n_valid, n), range(n_valid, n)] = 1.0
    return torch.tensor(M + np.float32(shift) * np.eye(n, dtype=np.float32))


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
