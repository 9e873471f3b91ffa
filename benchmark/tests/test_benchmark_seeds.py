"""The seeded inputs repeat, differ between seeds, give every seed the same
sizes, and take seeds of any size."""
import numpy as np
import pytest

from benchmark.harness import seeds

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3, -12]


@pytest.mark.parametrize("seed", SEEDS)
def test_perturbations_repeat_and_spare_the_quaternion(seed):
    a = seeds.perturbations(128, seed)
    b = seeds.perturbations(128, seed)
    assert a.shape == (128, 13)
    np.testing.assert_array_equal(a, b)
    assert not a[:, 6:10].any()
    assert 0.01 < a[:, :6].std() < 0.03


def test_seeds_and_streams_differ():
    a = seeds.perturbations(8, 1)
    assert not np.array_equal(a, seeds.perturbations(8, 2))
    noise = seeds.perturbations(8, 1, stream=seeds.NOISE_STREAM)
    assert not np.array_equal(a, noise)


@pytest.mark.parametrize("seed", SEEDS)
def test_joint_perturbations_repeat(seed):
    a = seeds.joint_perturbations(256, 12, seed, 0.01)
    np.testing.assert_array_equal(a, seeds.joint_perturbations(
        256, 12, seed, 0.01))
    assert a.shape == (256, 12)


@pytest.mark.parametrize("seed", SEEDS)
def test_samples_repeat_distinct_sorted(seed):
    s = seeds.sample(seed, 1000, 24)
    np.testing.assert_array_equal(s, seeds.sample(seed, 1000, 24))
    assert len(set(s.tolist())) == 24 and (np.diff(s) > 0).all()
    assert len(seeds.sample(seed, 5, 24)) == 5
    assert not np.array_equal(s, seeds.sample(seed, 1000, 24, salt=1))
