"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of a checkout (on the CPU; the tests marked ``cuda`` skip there
and run on the card with ``-m cuda``)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's runs and the TF32 "
                    "control run on the card")
    return "cuda"
