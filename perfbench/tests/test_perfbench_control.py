"""The correctness control: the reference put in the program's place, its
products one precision below the configuration's (fp8 for the train step's
bf16, TF32 for inference's f32), is not correct under each cell's limits.
Here at a size a test holds; `perfbench/calibrate.py` reads it on the card
at the cell's own size."""

import pytest

from perfbench import calibrate
from perfbench.lib import spec
from perfbench.tests import tiny

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_control_is_not_correct(name, seed):
    cell = tiny.cell(name)
    readings = calibrate.control(cell, seed, "cpu")
    assert set(readings) == set(cell.checks)
    assert any(readings[n] > cell.checks[n] for n in readings), readings
