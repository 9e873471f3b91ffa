"""A run of each cell, on the CPU at a small size, with the timed path
broken underneath, comes out not correct: for each fault that the cell can
have (a step that returns its state unchanged; half the batch left out,
its answers handed to the other half; an answer altered where it is
produced); the same run unbroken comes out correct.  No cell runs over
several chips, so none can leave an exchange between chips out.

The runs skip the look for a card (``run.main(device="cpu")``): the
program's loops run eagerly, with the plain versions of its kernels.  The
loop's window holds four periods or more, so that most of its sampled
MPC updates come after the first."""
import time

import pytest
import torch

from benchmark import run
from benchmark.faults import altered_gait, altered_torque, half_batch, unchanged

SMALL = {
    "a1_walk_n20.fleet_b128": ({"batch": 2, "check_answers": 4}, 1.0),
    "a1_sim_trot_n20.sim_b128": ({"batch": 2, "starts": 1,
                                  "check_periods": 6, "check_scenarios": 2,
                                  "check_ticks": 4}, 16.0),
}


CASES = [
    ("a1_walk_n20.fleet_b128", None, True),
    ("a1_walk_n20.fleet_b128", unchanged, False),
    ("a1_walk_n20.fleet_b128", half_batch, False),
    ("a1_walk_n20.fleet_b128", altered_gait, False),
    ("a1_sim_trot_n20.sim_b128", None, True),
    ("a1_sim_trot_n20.sim_b128", unchanged, False),
    ("a1_sim_trot_n20.sim_b128", half_batch, False),
    ("a1_sim_trot_n20.sim_b128", altered_torque, False),
]


@pytest.mark.parametrize("cell,fault,correct", CASES, ids=[
    f"{c.split('.')[1]}-{f.__name__ if f else 'sound'}"
    for c, f, _ in CASES])
def test_fault_comes_out_not_correct(monkeypatch, cell, fault, correct):
    torch.set_num_threads(2)
    if fault is not None:
        fault(monkeypatch.setattr)
    overrides, seconds = SMALL[cell]
    line = run.main(["--workload", cell, "--seed", "2024", "--seconds",
                     str(seconds), "--trace", "0"], device="cpu",
                    overrides=overrides, t_start=time.perf_counter())
    assert line["correct"] is correct, line["checks"]
