"""The port's golden rollout (``bilevel_gait_gen_tpu_torch/golden.py``)
against the JAX package's pinned float64 rollout, ``tests/golden/a1_trot.npz``,
at the bounds of ``tests/test_parity.py``.  The rollouts run once per dtype
on the CPU; nothing here runs JAX.

* float64: ``xs`` atol 1e-3, ``costs`` rtol / atol 1e-3, ``cost0`` rtol
  1e-3, the outer gradient's cosine > 1 - 1e-6 (test_parity.py:51-63);
* float32: ``costs`` rtol / atol 1e-2, ``xs[0]`` atol 1e-3 (:66-80), the
  cosine > 0.99 and the dominant boundary's sign (:121-136), and
  ``parity_report``'s cost and cosine verdicts at parity_tpu.py's bounds.
  The float32 states after the first step are not held to parity_tpu.py's
  5e-3 (test_parity.py:71-77: the merit line search and the quality gate
  are discrete branches that float32 flips; the JAX package's own float32
  rollout on the CPU is 0.2 off there).
"""
import numpy as np
import pytest
import torch

from bilevel_gait_gen_tpu_torch import golden as golden_mod

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return golden_mod.load_golden()


@pytest.fixture(scope="module")
def run_f64():
    return golden_mod.rollout(torch.float64, device="cpu")


@pytest.fixture(scope="module")
def run_f32():
    return golden_mod.rollout(torch.float32, device="cpu")


def test_rollout_has_the_golden_keys_and_shapes(golden, run_f64):
    xs, costs, grad, cost0 = run_f64
    assert xs.shape == golden["xs"].shape == (10, 13)
    assert costs.shape == golden["costs"].shape == (10,)
    assert grad.shape == golden["grad"].shape == (4, 9)
    assert xs.dtype == costs.dtype == grad.dtype == np.float64
    assert isinstance(cost0, float)
    assert golden_mod.GOLDEN.name == "a1_trot.npz"


def test_f64_matches_golden(golden, run_f64):
    xs, costs, grad, cost0 = run_f64
    np.testing.assert_allclose(xs, golden["xs"], atol=1e-3)
    np.testing.assert_allclose(costs, golden["costs"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(cost0, golden["cost0"], rtol=1e-3)
    g0, g1 = golden["grad"].ravel(), grad.ravel()
    denom = np.linalg.norm(g0) * np.linalg.norm(g1)
    assert denom > 0
    assert np.dot(g0, g1) / denom > 1.0 - 1e-6
    rep = golden_mod.parity_report(golden, run_f64)
    assert rep["ok"], rep


def test_f32_tracks_f64(golden, run_f32):
    xs, costs, grad, _ = run_f32
    assert np.all(np.isfinite(xs))
    np.testing.assert_allclose(costs, golden["costs"], rtol=1e-2, atol=1e-2)
    # the first step is branch-free from the converged start: tight bound
    np.testing.assert_allclose(xs[0], golden["xs"][0], atol=1e-3)


def test_f32_gradient_direction_and_parity_report(golden, run_f32):
    g64 = golden["grad"].ravel()
    g32 = run_f32[2].ravel()
    assert np.all(np.isfinite(g32))
    cos = np.dot(g64, g32) / (np.linalg.norm(g64) * np.linalg.norm(g32))
    assert cos > 0.99, f"gradient cosine {cos}"
    i = np.argmax(np.abs(g64))
    assert np.sign(g64[i]) == np.sign(g32[i])
    assert np.abs(g32[i]) > 0.3 * np.max(np.abs(g32))
    rep = golden_mod.parity_report(golden, run_f32)
    assert rep["finite"]
    assert rep["dc"] < golden_mod.DC_BOUND, rep
    assert rep["cos"] > golden_mod.COS_BOUND, rep
    assert rep["cos"] == pytest.approx(cos, rel=1e-12)
    assert rep["dx"] == np.max(np.abs(run_f32[0] - golden["xs"]))
