"""The control, the reference put in the program's place in TF32 (the
precision below the configurations' float32 with TF32 off), fails each
cell's comparison, and the program passes it, on the card at a size that
a test run holds (``benchmark/control.py`` reads both at the cells' own
sizes)."""
import pytest

from benchmark import control
from benchmark.harness import core

SMALL = {
    "a1_walk_n20.fleet_b128": ({"batch": 32, "check_answers": 16}, 5.0),
    "a1_sim_trot_n20.sim_b128": ({"batch": 16, "starts": 1,
                                  "check_periods": 64, "check_scenarios": 2,
                                  "check_ticks": 3}, 30.0),
}


def failed(readings: dict, limits: dict) -> list[str]:
    return [k for k, lim in limits.items()
            if not readings.get(k, float("inf")) <= lim]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_program_passes(card, cell):
    overrides, seconds = SMALL[cell]
    ctx = core.load_ctx(cell, 1, seconds, False, 0.0, card)
    r = control.readings(cell, 31337, seconds, device=card,
                         overrides=overrides)
    limits = ctx.limits["numbers"]
    assert not failed(r["readings"]["program"], limits), r["readings"]
    assert failed(r["readings"]["control_tf32"], limits), r["readings"]
