"""`correct` comes out true for a sound run and false for the control and
for each fault a cell can have. The runs here skip the command's look for a
card and drive the rest of a run on the CPU at small sizes; the tests marked
`cuda` repeat the control at each cell's own size on the card."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import faults
from benchmark.control import readings
from benchmark.harness import cell_of, entry_module, load_spec, run_cell
from benchmark.tests.conftest import full_cell, small_cell

CELLS = [w["name"] for w in load_spec()["workloads"]]
# and the serving cell, whose pieces are here though BENCHMARK.json leaves it out
PIECES = CELLS + ["tsukuba16.serve"]
SEED = 2**31 + 4099


def _run(cell, seconds=3.0):
    return run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter())


def _over(numbers: dict, limits: dict) -> bool:
    """Whether any number fails its limit, as `run_cell` judges."""
    return not all(numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("name", PIECES)
def test_a_sound_run_is_correct(name):
    out = _run(small_cell(name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("name,fault", [(c, f) for c in PIECES
                                        for f in faults.FAULTS[full_cell(c).traffic["entry"]]])
def test_a_fault_is_not_correct(name, fault):
    with faults.planted(fault):
        out = _run(small_cell(name))
    assert not out["correct"], out["checks"]


def test_the_serving_control_is_not_correct():
    """The serving cell at its own frame size (a smaller pool): the
    reference with an fp8 state and fp8 incidence blocks in the program's
    place fails the limit."""
    cell = full_cell("tsukuba16.serve")
    cell.traffic.update(pool=8, check_frames=2)
    entry = entry_module(cell).Entry(cell.config, cell.traffic, SEED, torch.device("cpu"))
    entry.unit(0)  # the server calibrates on its first batch
    assert _over(entry.control(), cell.limits)


def test_the_training_control_is_not_correct():
    cell = small_cell("tsukuba16.train")
    entry = entry_module(cell).Entry(cell.config, cell.traffic, SEED, torch.device("cpu"))
    assert _over(entry.control(), cell.limits)
    assert not _over(entry.check(), cell.limits)


def test_the_full_size_control_reads_far_above_the_program():
    """fullres128's limit is set from full-size readings, which a CPU run
    cannot make; at a small size the control still reads several times
    what the program does."""
    cell = small_cell("fullres128.stream")
    row = readings(cell, SEED, 3.0, True, torch.device("cpu"))
    assert row["control"]["disp_gap_px"] >= 3 * row["program"]["disp_gap_px"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_the_cells_size(card, name):
    cell = cell_of(load_spec(), name)
    row = readings(cell, SEED, 8.0, True, card)
    assert not _over(row["program"], cell.limits), row
    assert _over(row["control"], cell.limits), row
