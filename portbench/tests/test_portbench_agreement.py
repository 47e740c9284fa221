"""The drivers and the reference agree at the mini fixtures' widths (float32
on the CPU), on small batches, under the cells' own limits; and each fault
that a cell can have, planted underneath the timed path, turns ``correct``
false. The runs skip the harness's look for a card and drive the rest."""

import time

import numpy as np
import pytest
import torch

from portbench import readings, run
from portbench.tests.mini import mini_segment_cell, mini_train_cell

SEED = 3000000019


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def result(cell, seed=SEED):
    return run.run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter())


def test_segment_driver_agrees_with_the_reference():
    res = result(mini_segment_cell())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 8
    assert res["checks"] and all(c["value"] < 1e-4 for c in res["checks"].values())
    assert res["_numbers"]["segments_program"] == res["_numbers"]["segments_reference"] > 0


def test_train_driver_agrees_with_the_reference():
    res = result(mini_train_cell())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"] and all(c["value"] < 1e-4 for c in res["checks"].values())


@pytest.mark.parametrize("fault", ["half_rows", "altered", "shifted"])
def test_segment_faults_are_not_correct(fault):
    """The segment driver's faults, planted under the timed path: half of each
    batch's rows left out, an answer altered where it is produced, the
    segment features moved by one segment."""
    cell = mini_segment_cell()
    assert not result(cell._replace(config=dict(cell.config, _stand_in=fault)))["correct"]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from sylber_tpu_torch.train import distill

    loss = distill.distill_loss

    def half(student, teacher, thresholder, batch, *a, **k):
        rows = batch["input_values"].shape[0] // 2
        batch = {key: (v[:rows] if v is not None else None) for key, v in batch.items()}
        return loss(student, teacher, thresholder, batch, *a, **k)
    monkeypatch.setattr(distill, "distill_loss", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_train_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not result(mini_train_cell())["correct"]


def test_train_stand_ins_are_not_correct():
    """The control (the reference in fp8) and the half-batch fault, put in
    the program's place in the cell's check, fail the cell's limits."""
    cell = mini_train_cell()
    for c in (readings.control_cell(cell),
              cell._replace(config=dict(cell.config, _stand_in="half_batch"))):
        assert not result(c)["correct"]


def test_segment_seed_gives_the_same_inputs():
    from portbench.drivers.segment import make_batches

    traffic = mini_segment_cell().workload["traffic"]
    a, b = make_batches(traffic, SEED, 16000), make_batches(traffic, SEED, 16000)
    c = make_batches(traffic, SEED + 1, 16000)
    assert all(np.array_equal(x, y) for (wa, _, _), (wb, _, _) in zip(a, b)
               for x, y in zip(wa, wb))
    assert [L for _, L, _ in a] == [L for _, L, _ in c]  # the same shapes, other speech
    assert not np.array_equal(a[0][0][0], c[0][0][0])


def test_shifted_features_fail_the_feature_gap_alone():
    """Features moved by one segment keep the segments and the norms, and
    the per-segment feature gap is the number that catches them."""
    cell = mini_segment_cell()
    res = result(cell._replace(config=dict(cell.config, _stand_in="shifted")))
    checks = res["checks"]
    assert checks["feature_gap_max"]["value"] > checks["feature_gap_max"]["limit"]
    assert checks["boundary_miss"]["value"] == 0.0 and checks["norm_gap"]["value"] < 1e-4
