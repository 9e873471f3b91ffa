"""Inertia merging for fixed joints (the part of
``bilevel_gait_gen_tpu/models/urdf.py`` that make_a1 needs; the URDF
parser itself is not ported yet)."""
from __future__ import annotations

import numpy as np


def _merge_inertia(m1, c1, I1, m2, c2, I2):
    """Merge two bodies expressed in the same frame (inertias about their
    own COMs)."""
    m = m1 + m2
    if m == 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    c = (m1 * c1 + m2 * c2) / m

    def shift(mi, ci, Ii):
        d = ci - c
        return Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(m1, c1, I1) + shift(m2, c2, I2)
