"""On the card: each cell's control comes out not correct at the cell's own
size on three seeds, and a short run of each cell comes out correct.
Run with ``python3 -m pytest portbench/tests -m cuda`` on the card."""

import time

import pytest

from portbench import readings, run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(cuda_device, name):
    cell = readings.control_cell(spec.cell(name))
    for seed in (3000000101, 3000000102, 3000000103):
        res = run.run_cell(cell, seed, 4.0, False, cuda_device, time.perf_counter())
        assert not res["correct"], (seed, res["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(cuda_device, name):
    res = run.run_cell(spec.cell(name), 3000000104, 4.0, False, cuda_device,
                       time.perf_counter())
    assert res["correct"], res["checks"]
