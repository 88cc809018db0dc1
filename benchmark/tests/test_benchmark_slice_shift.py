"""The lattice apply's shifted-slice metric, on counters filled by a
profiled slice of the cell's entry on the CPU at a small size (the trace
itself is made up: a CPU run has no device trace). The stream cells run the
fused bf16 loop through one untiled plan, so every update's message comes
from the shifted slice (on the CPU its plain version) and the share reads
100."""
from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace as T
from benchmark.harness import Reading, entry_module, metric_reader
from benchmark.tests.conftest import small_cell
from depth_estimation_torch.ops.cuda import lattice as LK
from depth_estimation_torch.utils import profiling

SEED = 2**31 + 2011
UNITS = 2
MADE_UP = T.reduce_events([("k", 0.0, 1.0)], [("aten::add", 0.0, 2.0)], window_s=2e-6)


def test_shift_share_reads_the_counters_and_nothing_without_them(monkeypatch):
    cell = small_cell("fullres128.stream")
    # kept untiled as at full size (see test_benchmark_kernel_pct)
    cell.config["infer"]["calibrate"]["tiled"] = False
    entry = entry_module(cell).Entry(cell.config, cell.traffic, SEED, torch.device("cpu"))
    entry.warm()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(UNITS):
            entry.unit(entry.next_unit + i)
    reading = Reading(cell, entry, MADE_UP, UNITS, None)
    read = metric_reader("slice_shift_pct")
    c = profiling.counter_totals()
    assert c["lattice.slice.shifted"] == c["meanfield.update"] == UNITS * cell.config["niters"]
    assert read(reading) == 100.0
    with monkeypatch.context() as m:  # no update's message shifted by the slice
        m.setattr(profiling, "counter_totals",
                  lambda: {k: v for k, v in c.items() if k != "lattice.slice.shifted"})
        assert read(reading) == 0.0
    # nothing traced; a program without the shifted slice or without counters; counters emptied
    assert read(Reading(cell, entry, None, UNITS, None)) is None
    with monkeypatch.context() as m:
        m.delattr(LK, "slice_untiled_shifted")
        assert read(reading) is None
    with monkeypatch.context() as m:
        m.delattr(profiling, "counter_totals")
        assert read(reading) is None
    profiling.reset_counters()
    assert read(reading) is None
