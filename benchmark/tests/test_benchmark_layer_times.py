"""The layer times read from the program's spans, the K1 metrics, and the
middlebury64.stream cell's files and its rate of its own: the span reduction on a profiled slice of
a cell's entry on the CPU at a small size, the readers on readings made up
here (a CPU run has no device trace)."""
from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import counts, trace as T
from benchmark.harness import (Reading, _traced, cell_of, end_to_end_value, entry_module,
                               load_spec, metric_reader)
from benchmark.tests.conftest import small_cell
from depth_estimation_torch.utils import profiling

SEED = 2**31 + 2027
UNITS = 2
MADE_UP = T.reduce_events([("k", 0.0, 1.0)], [("aten::add", 0.0, 2.0)], window_s=2e-6)
SPEC = load_spec()
# the layer times of the stream cells whose rate is `frames_per_s`
# (wide320.stream's list of metrics is held fixed by a test of the
# program's, tests/test_torch_wide320.py) and of middlebury64.stream, whose
# rate is `frames_per_s.narrow`: each metric's span and the cells that report it
WIDE = ["fullres128.stream"]
NARROW = ["middlebury64.stream"]
SPAN_METRICS = {"unary_ms": ("stereo.unary", WIDE), "plan_ms.infer": ("lattice.plan", WIDE),
                "splat_ms": ("lattice.splat", WIDE), "blur_ms": ("lattice.blur", WIDE),
                "slice_ms": ("lattice.slice", WIDE), "update_ms": ("meanfield.update", WIDE),
                "unary_ms.narrow": ("stereo.unary", NARROW),
                "plan_ms.narrow": ("lattice.plan", NARROW),
                "splat_ms.narrow": ("lattice.splat", NARROW),
                "blur_ms.narrow": ("lattice.blur", NARROW),
                "slice_ms.narrow": ("lattice.slice", NARROW),
                "update_ms.narrow": ("meanfield.update", NARROW),
                "plan_ms.train": ("lattice.plan", ["tsukuba16.train"]),
                "backward_ms": ("lattice.backward", ["tsukuba16.train"])}
# middlebury64.stream's copies of the stream cells' shared metrics: each
# reads as the metric it copies, and moves `frames_per_s.narrow`
NARROW_COPIES = {m["name"]: m["name"].rsplit(".", 1)[0] for m in SPEC["per_layer"]
                 if m["name"].endswith(".narrow")}
NARROW_COPIES.update({"device_idle_pct.narrow": "device_idle_pct.infer",
                      "plan_ms.narrow": "plan_ms.infer"})
K1 = "void fused_energy_update_kernel<64, __nv_bfloat16>(__nv_bfloat16 const*, long long, int)"
OTHERS = ["void fused_energy_update_wide_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*)",
          "void fused_energy_update_xwide_kernel<__nv_bfloat16, 64, 10>(__nv_bfloat16 const*)",
          "fused_energy_update_xwide_tile_mu_kernel", "fused_energy_update_xxwide_kernel",
          "my_fused_energy_update_kernel_v2"]


def _reading(name, trace, spans=None, units=3, frames_per_unit=1):
    cell = cell_of(SPEC, name)
    state = types.SimpleNamespace(tile_px=None, compute_dtype="bf16")
    entry = types.SimpleNamespace(frames_per_unit=frames_per_unit, program_state=lambda: state)
    return Reading(cell, entry, trace, units, None, spans)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_layer_time_reads_its_span(metric):
    span, cells = SPAN_METRICS[metric]
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    assert (entry["unit"], entry["better"], entry["source"]) == ("ms", "lower", "device_trace")
    assert entry["workloads"] == cells
    read = metric_reader(metric)
    spans = {span: (15, 0.042), "lattice.other": (1, 1.0), "aten::add": (9, 9.0)}
    assert read(_reading(cells[0], MADE_UP, spans)) == pytest.approx(1e3 * 0.042 / 3)
    batched = _reading(cells[0], MADE_UP, spans, units=2, frames_per_unit=8)
    assert read(batched) == pytest.approx(1e3 * 0.042 / 16)
    # nothing traced, no spans kept, the span absent (renamed): nothing, not 0
    assert read(_reading(cells[0], None, spans)) is None
    assert read(_reading(cells[0], MADE_UP, None)) is None
    assert read(_reading(cells[0], MADE_UP, {"lattice.other": (1, 1.0)})) is None


def test_the_span_reduction_on_a_profiled_slice():
    """The spans of a small stream cell's units under the profiler: each
    of the program's spans by name, as many as the program's own totals
    count, and none of PyTorch's operators."""
    cell = small_cell("middlebury64.stream")
    entry = entry_module(cell).Entry(cell.config, cell.traffic, SEED, torch.device("cpu"))
    entry.warm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(UNITS):
            entry.unit(entry.next_unit + i)
    spans = T.spans_from_profiler(prof)
    niters = cell.config["niters"]
    assert spans["stereo.frame"][0] == spans["stereo.unary"][0] == UNITS
    for name in ("lattice.splat", "lattice.blur", "lattice.slice", "meanfield.update"):
        assert spans[name][0] == UNITS * niters, name
    assert spans["lattice.plan"][0] >= UNITS
    assert not [k for k in spans if "::" in k]
    assert all(s == 0.0 for _, s in spans.values())  # no device on the CPU
    mine = profiling.span_totals(prof)
    assert {k: v["count"] for k, v in mine.items()} == {k: spans[k][0] for k in mine}
    # the harness's traced slice keeps them; the device trace of a CPU run is empty
    trace, kept, failed = _traced(entry, entry.next_unit + UNITS, 1, torch.device("cpu"))
    assert trace is None and failed == 0
    assert kept["stereo.frame"][0] == 1 and kept["meanfield.update"][0] == niters


def test_k1_roofline_reads_k1_alone():
    read = metric_reader("k1_roofline_pct")
    device = [(K1, 0.0, 500.0), (K1, 600.0, 1100.0)] + [(k, 1200.0 + 10 * i, 1205.0 + 10 * i)
                                                        for i, k in enumerate(OTHERS)]
    t = T.reduce_events(device, [("aten::add", 0.0, 1300.0)], window_s=1.3e-3)
    r = _reading("middlebury64.stream", t)
    assert read(r) == pytest.approx(100 * counts.k1w_bound_s(994 * 1482, 64, 2) / 500e-6)
    assert 50 < read(r) < 60  # 281.43 µs of bytes over 500 µs
    only_others = T.reduce_events(device[2:], [("aten::add", 0.0, 1300.0)], window_s=1.3e-3)
    assert read(_reading("middlebury64.stream", only_others)) is None
    assert read(_reading("middlebury64.stream", None)) is None
    # K1w's and K1x's readers do not take K1's launches either
    k1_only = T.reduce_events(device[:2], [("aten::add", 0.0, 1300.0)], window_s=1.3e-3)
    for other in ("k1w_roofline_pct", "k1x_roofline_pct"):
        assert metric_reader(other)(_reading("middlebury64.stream", k1_only)) is None


def test_k1_share_reads_the_counters(monkeypatch):
    read = metric_reader("k1_update_pct")
    r = _reading("middlebury64.stream", MADE_UP)
    with monkeypatch.context() as m:
        m.setattr(profiling, "counter_totals",
                  lambda: {"meanfield.update": 10, "meanfield.update.K1": 10})
        assert read(r) == 100.0
        m.setattr(profiling, "counter_totals",
                  lambda: {"meanfield.update": 10, "meanfield.update.K1w": 10})
        assert read(r) == 0.0
        m.setattr(profiling, "counter_totals", lambda: {})
        assert read(r) is None
    assert read(_reading("middlebury64.stream", None)) is None


def test_the_middlebury64_cell_loads_by_name():
    cell = cell_of(SPEC, "middlebury64.stream")
    c, t = cell.config, cell.traffic
    assert (c["height"], c["width"], c["num_disp"], c["window_size"], c["niters"]) == (
        994, 1482, 64, 9, 5)
    assert (c["gamma"], c["sigma_color"], c["sigma_pos"], c["mu_scale"]) == (3.0, 0.1, 0.1, 1.0)
    assert c["infer"] == cell_of(SPEC, "wide320.stream").config["infer"]
    assert t["entry"] == "stream" and t["max_disp"] == c["num_disp"] - 2
    assert {k: v for k, v in t.items() if k != "max_disp"} == {
        k: v for k, v in cell_of(SPEC, "fullres128.stream").traffic.items() if k != "max_disp"}
    assert set(cell.limits) == {"disp_gap_px"}
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s.narrow", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert layer == {"k1_roofline_pct", "k1_update_pct", *NARROW_COPIES}
    assert {m["moves"] for m in cell.per_layer} == {"frames_per_s.narrow"}


def test_the_stream_cells_keep_their_rate_apart():
    """fullres128.stream and wide320.stream report `frames_per_s`, held to
    their own bound; middlebury64.stream reports it as `frames_per_s.narrow`
    under a bound of its own, and none of the metrics that move the first."""
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["frames_per_s"]["workloads"] == ["fullres128.stream", "wide320.stream"]
    assert e2e["frames_per_s.narrow"]["workloads"] == ["middlebury64.stream"]
    assert {k: v for k, v in e2e["frames_per_s"].items() if k not in ("name", "bound", "workloads")} \
        == {k: v for k, v in e2e["frames_per_s.narrow"].items()
            if k not in ("name", "bound", "workloads")}
    for name in ("fullres128.stream", "wide320.stream"):
        cell = cell_of(SPEC, name)
        assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
        assert not {m["name"] for m in cell.per_layer} & set(NARROW_COPIES)


def test_a_qualified_rate_is_the_entrys_own():
    values = {"setup_s": 9.5, "frames_per_s": 36.9}
    assert end_to_end_value(values, "frames_per_s.narrow") == 36.9
    assert end_to_end_value(values, "frames_per_s") == 36.9
    assert end_to_end_value({**values, "frames_per_s.narrow": 1.0}, "frames_per_s.narrow") == 1.0
    with pytest.raises(KeyError):
        end_to_end_value(values, "train_step_ms")


@pytest.mark.parametrize("copy", sorted(NARROW_COPIES))
def test_a_narrow_copy_reads_as_the_metric_it_copies(copy, monkeypatch):
    base = NARROW_COPIES[copy]
    mine = next(m for m in SPEC["per_layer"] if m["name"] == copy)
    theirs = next(m for m in SPEC["per_layer"] if m["name"] == base)
    assert {k: v for k, v in mine.items() if k not in ("name", "moves", "workloads")} == {
        k: v for k, v in theirs.items() if k not in ("name", "moves", "workloads")}
    assert mine["moves"] == "frames_per_s.narrow" and mine["workloads"] == NARROW
    monkeypatch.setattr(profiling, "counter_totals", lambda: {
        "meanfield.update": 10, "meanfield.update.K1": 10, "lattice.slice.shifted": 10,
        "lattice.apply.untiled": 10, "lattice.apply.kernel": 10, "costvolume.calls": 1,
        "costvolume.kernel": 1, "lattice.vertices": 300000, "lattice.capacity": 1300000})
    spans = {"stereo.unary": (3, 0.001), "lattice.plan": (3, 0.03), "lattice.splat": (15, 0.007),
             "lattice.blur": (15, 0.012), "lattice.slice": (15, 0.003),
             "meanfield.update": (15, 0.008)}
    k1 = T.reduce_events([(K1, 0.0, 500.0), ("costvolume_reflect_kernel", 600.0, 900.0)],
                         [("aten::add", 0.0, 1300.0)], window_s=1.3e-3)
    r = _reading("middlebury64.stream", k1, spans)
    r.syncs = 30
    assert metric_reader(copy)(r) == metric_reader(base)(r) is not None
    untraced = _reading("middlebury64.stream", None, None)
    assert metric_reader(copy)(untraced) is metric_reader(base)(untraced) is None
