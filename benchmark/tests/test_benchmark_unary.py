"""The unary layer's per-layer metrics on stub runs: the kernel's share of
the cost volume's calls, read from the program's counters, and its share
of its roofline, read from a made-up trace."""
from __future__ import annotations

import importlib.util
import types

import pytest

from benchmark import counts
from benchmark import trace as T
from benchmark.harness import BENCH, Reading, metric_reader
from benchmark.tests.conftest import full_cell
from depth_estimation_torch.utils import profiling

KERNEL = "void (anonymous namespace)::costvolume_reflect_kernel<3>(float const*, float const*)"


def _module(name: str):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reading(cell: str, kernels=(), tile_px=None) -> Reading:
    """A traced run of `cell` whose trace holds `kernels` ((name, µs)
    launches, one after the other), or an untraced one without kernels."""
    entry = types.SimpleNamespace(program_state=lambda: types.SimpleNamespace(tile_px=tile_px))
    events, t = [], 0.0
    for name, us in kernels:
        events.append((name, t, t + us))
        t += us
    trace = T.reduce_events(events, [("aten::add", 0.0, t + 1.0)], window_s=(t + 1.0) * 1e-6)
    return Reading(full_cell(cell), entry, trace, 1, None)


def test_unary_kernel_pct_reads_the_counters(monkeypatch):
    read = metric_reader("unary_kernel_pct")
    run = _reading("fullres128.stream", [("k", 1.0)])
    assert read(Reading(run.cell, run.entry, None, 1, None)) is None  # nothing traced
    monkeypatch.setattr(profiling, "counter_totals", lambda: {})
    assert read(run) is None  # no call counted (a program without the counters)
    monkeypatch.setattr(profiling, "counter_totals",
                        lambda: {"costvolume.calls": 3, "costvolume.kernel": 3})
    assert read(run) == 100.0
    monkeypatch.setattr(profiling, "counter_totals", lambda: {"costvolume.calls": 4})
    assert read(run) == 0.0  # every call took the plain version
    monkeypatch.delattr(profiling, "counter_totals")
    assert read(run) is None


@pytest.mark.parametrize("cell,h,w,L,gb", [("fullres128.stream", 1088, 1920, 128, 1.120),
                                           ("wide320.stream", 994, 1482, 320, 1.921)])
def test_unary_roofline_pct_at_the_stream_cells(cell, h, w, L, gb):
    mod = _module("unary_roofline_pct")
    config = full_cell(cell).config
    assert (config["height"], config["width"], config["num_disp"]) == (h, w, L)
    nbytes = mod.least_bytes(h, w, L)
    assert nbytes == (2 * h * w * 3 + h * w * L) * 4 and round(nbytes / 1e9, 3) == gb
    least_us = nbytes / counts.PEAK["hbm_bytes_per_s"] * 1e6
    # two launches, at twice and at four thirds of the least time: 60% on average
    run = _reading(cell, [(KERNEL, 2 * least_us), (KERNEL, 4 / 3 * least_us), ("other", 5.0)])
    assert mod.read(run) == pytest.approx(60.0)
    # a tiled frame pads h and w to its tiles
    tiled = _reading(cell, [(KERNEL, least_us)], tile_px=32)
    padded = mod.least_bytes(h + (-h % 32), w + (-w % 32), L)
    assert mod.read(tiled) == pytest.approx(100.0 * padded / nbytes)


def test_unary_roofline_pct_reads_nothing_without_the_kernel():
    read = metric_reader("unary_roofline_pct")
    assert read(_reading("wide320.stream", [("void at::native::elementwise_kernel", 9.0)])) is None
    run = _reading("wide320.stream", [(KERNEL, 9.0)])
    assert read(Reading(run.cell, run.entry, None, 1, None)) is None
