"""The lattice apply's per-layer metric, on counters filled by a profiled
slice of the cell's entry on the CPU at a small size (the trace itself is
made up: a CPU run has no device trace). On the CPU the untiled applies
take the plain versions, so the share reads 0."""
from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace as T
from benchmark.harness import Reading, entry_module, metric_reader
from benchmark.tests.conftest import small_cell
from depth_estimation_torch.utils import profiling

SEED = 2**31 + 617
UNITS = 2
MADE_UP = T.reduce_events([("k", 0.0, 1.0)], [("aten::add", 0.0, 2.0)], window_s=2e-6)


def test_kernel_share_reads_the_counters_and_nothing_without_them(monkeypatch):
    cell = small_cell("fullres128.stream")
    # at full size the calibration finds the tiled blocks above its limit
    # and keeps the plan untiled; the small copy is kept untiled alike
    cell.config["infer"]["calibrate"]["tiled"] = False
    entry = entry_module(cell).Entry(cell.config, cell.traffic, SEED, torch.device("cpu"))
    entry.warm()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(UNITS):
            entry.unit(entry.next_unit + i)
    reading = Reading(cell, entry, MADE_UP, UNITS, None)
    read = metric_reader("lattice_kernel_pct")
    c = profiling.counter_totals()
    assert c["lattice.apply.untiled"] == UNITS * cell.config["niters"]
    assert read(reading) == 0.0
    with monkeypatch.context() as m:  # every apply through the kernels
        m.setattr(profiling, "counter_totals",
                  lambda: {**c, "lattice.apply.kernel": c["lattice.apply.untiled"]})
        assert read(reading) == 100.0
    # nothing traced; a program without counters; counters emptied
    assert read(Reading(cell, entry, None, UNITS, None)) is None
    with monkeypatch.context() as m:
        m.delattr(profiling, "counter_totals")
        assert read(reading) is None
    profiling.reset_counters()
    assert read(reading) is None
