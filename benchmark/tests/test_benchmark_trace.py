"""The trace's reduction and the per-layer metrics' readers, on events made
up here (a CPU run has no device trace)."""
from __future__ import annotations

import types

import pytest

from benchmark import counts, trace as T
from benchmark.harness import Reading, cell_of, load_spec, metric_reader

DEVICE = [("k_a", 0.0, 10.0), ("k_b", 5.0, 20.0), ("Memcpy HtoD (Pageable -> Device)", 30.0, 35.0),
          ("fused_energy_update_wide_kernel<bf16, 128>", 40.0, 41.0),
          ("fused_energy_update_wide_kernel<bf16, 128>", 50.0, 51.0)]
HOST = [("aten::outer", 0.0, 60.0), ("aten::sort", 21.0, 29.0), ("aten::item", 36.0, 39.0)]


def test_reduce_events():
    t = T.reduce_events(DEVICE, HOST, window_s=60e-6)
    assert t.busy_s == pytest.approx(27e-6)  # [0, 20] ∪ [30, 35] ∪ [40, 41] ∪ [50, 51]
    assert t.kernels["k_a"] == (1, pytest.approx(10e-6))
    assert t.kernels["fused_energy_update_wide_kernel<bf16, 128>"] == (2, pytest.approx(2e-6))
    assert t.copies_s == pytest.approx(5e-6)
    # each gap goes to the innermost host op at its midpoint
    assert t.idle_by_host == {"aten::sort": pytest.approx(10e-6),
                              "aten::item": pytest.approx(5e-6),
                              "aten::outer": pytest.approx(9e-6)}
    assert T.idle_pct(t) == pytest.approx(100 * (1 - 27 / 60))
    b = T.breakdown(t, top=2)
    assert b["device_ops"] == [["k_b", pytest.approx(15e-6)], ["k_a", pytest.approx(10e-6)]]
    assert b["idle_gaps"][0] == ["aten::sort", pytest.approx(10e-6)]
    assert T.reduce_events([], HOST, 1.0) is None


def _reading(name, trace, syncs=None, units=2, frames_per_unit=1):
    cell = cell_of(load_spec(), name)
    state = types.SimpleNamespace(tile_px=None, compute_dtype="bf16")
    entry = types.SimpleNamespace(frames_per_unit=frames_per_unit, program_state=lambda: state)
    return Reading(cell, entry, trace, units, syncs)


def test_readers_read_nothing_without_a_trace():
    for name in (w["name"] for w in load_spec()["workloads"]):
        for m in cell_of(load_spec(), name).per_layer:
            assert metric_reader(m["name"])(_reading(name, None)) is None


def test_readers_on_a_made_up_trace():
    t = T.reduce_events(DEVICE, HOST, window_s=0.7)
    r = _reading("fullres128.stream", t, syncs=20)
    assert metric_reader("device_idle_pct.infer")(r) == pytest.approx(100 * (1 - 27e-6 / 0.7))
    assert metric_reader("kernels_per_frame")(r) == 2.0  # 4 kernels over 2 frames
    assert metric_reader("host_syncs_per_frame")(r) == 9.0  # less one fetch a frame
    n = 1088 * 1920
    assert metric_reader("k1w_roofline_pct")(r) == pytest.approx(
        100 * counts.k1w_bound_s(n, 128, 2) / 1e-6)
    assert metric_reader("frame_mfu_pct")(r) == pytest.approx(
        100 * counts.frame_least_s(1088, 1920, 128, 5, 2) / 0.35)
    batched = _reading("fullres128.stream", t, syncs=20, frames_per_unit=8)
    assert metric_reader("host_syncs_per_frame")(batched) == pytest.approx(18 / 16)
    assert metric_reader("k1w_roofline_pct")(_reading("fullres128.stream", T.reduce_events(
        DEVICE[:2], HOST, 1.0))) is None
    train = _reading("tsukuba16.train", t, syncs=12, units=4)
    assert metric_reader("host_syncs_per_step")(train) == 2.0
