"""The per-layer metric that reads the program's counters, on counters
filled by a profiled slice of the cell's entry on the CPU at a small size
(the trace itself is made up: a CPU run has no device trace)."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace as T
from benchmark.harness import Reading, entry_module, metric_reader
from benchmark.tests.conftest import small_cell
from depth_estimation_torch.utils import profiling

SEED = 2**31 + 613
UNITS = 2
MADE_UP = T.reduce_events([("k", 0.0, 1.0)], [("aten::add", 0.0, 2.0)], window_s=2e-6)


def test_fill_reads_the_counters_and_nothing_from_empty_ones(monkeypatch):
    cell = small_cell("fullres128.stream")
    entry = entry_module(cell).Entry(cell.config, cell.traffic, SEED, torch.device("cpu"))
    entry.warm()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(UNITS):
            entry.unit(entry.next_unit + i)
    reading = Reading(cell, entry, MADE_UP, UNITS, None)
    read = metric_reader("lattice_fill_pct")
    c = profiling.counter_totals()
    value = read(reading)
    assert value == pytest.approx(100 * c["lattice.vertices"] / c["lattice.capacity"])
    assert 0 < value <= 100
    # nothing traced; a program without counters; counters emptied
    assert read(Reading(cell, entry, None, UNITS, None)) is None
    with monkeypatch.context() as m:
        m.delattr(profiling, "counter_totals")
        assert read(reading) is None
    profiling.reset_counters()
    assert read(reading) is None
