"""The seeded inputs, frozen here so that a change of the program cannot
move them: the same ``--seed`` gives the same inputs, and every seed the
same sizes.

Each use draws from its own stream of ``numpy.random.default_rng([seed mod
2**64, stream])``, so that a seed of any size (negative ones included)
works, and one use's draws do not shift another's.
"""
from __future__ import annotations

import numpy as np

STATE_STREAM = 0      # the measured states' perturbations
JOINT_STREAM = 1      # the closed loop's joint perturbations
SAMPLE_STREAM = 2     # which answers the comparison checks
NOISE_STREAM = 3      # the measured states' sensor noise


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def perturbations(batch: int, seed: int, scale: float = 0.02,
                  stream: int = STATE_STREAM) -> np.ndarray:
    """[batch, 13] state perturbations, ``scale`` * N(0, 1), none on the
    quaternion (entries 6-9): ``problem.perturbations`` of the port, which
    draws from ``default_rng(seed)``."""
    pert = scale * rng(seed, stream).standard_normal((batch, 13))
    pert[:, 6:10] = 0.0
    return pert


def joint_perturbations(batch: int, joints: int, seed: int,
                        scale: float) -> np.ndarray:
    """[batch, joints] joint offsets, ``scale`` * N(0, 1) rad
    (``chip_smoke.loop_start``'s, which draws from ``default_rng(0)``)."""
    return scale * rng(seed, JOINT_STREAM).standard_normal((batch, joints))


def sample(seed: int, population: int, k: int, salt: int = 0) -> np.ndarray:
    """``k`` distinct indices of ``range(population)`` (all of them where
    ``k >= population``), sorted."""
    k = min(k, population)
    g = rng(seed, SAMPLE_STREAM + 10 * (salt + 1))
    return np.sort(g.choice(population, size=k, replace=False))
