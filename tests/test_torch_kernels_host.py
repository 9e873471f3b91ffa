"""The CUDA sources compiled for the host (``torch_kernel_common.host_lib``):
``gtwg``, the Newton-Schulz product, the p <= 32 sweep and ``gj_inverse``
through the wrappers' CUDA branch on CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu.ops import pallas_kernels as pk
from bilevel_gait_gen_tpu_torch.ops import kernels

from torch_kernel_common import (
    _gtwg_data, _sweep_state, _spd_batch, host_lib, host_card,
    _padded_spd_batch)


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
