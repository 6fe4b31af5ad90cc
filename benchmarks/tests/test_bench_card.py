"""On the card only (marked `cuda`, skipped without one): a short run of
each cell comes out correct, and the control (TF32 for the float32 zoo,
float8 for the bf16 UNet) and each planted fault fail the cell's limits,
at the cells' own sizes."""

import time

import pytest

from benchmarks import readings, registry, run

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(card, name):
    line, notes = run.run_cell(registry.benchmark(), name, 2 ** 31 + 101,
                               2.0, 0, card, time.time())
    assert line["correct"], notes
    assert line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_card(card, name):
    cell = registry.cell(name)
    config = registry.config(cell["config"])
    r = readings.read_seed(config, cell, 2 ** 31 + 202, card)
    limits = cell["limits"]
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
    for fault in ("half_batch", "half_batch_replay"):
        assert any(r[fault][k] > v for k, v in limits.items()), (fault, r)
