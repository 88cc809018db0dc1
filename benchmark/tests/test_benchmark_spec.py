"""BENCHMARK.json against the benchmark's contract, and everything it names
found by name under the benchmark's folder."""
from __future__ import annotations

import json
import re
import types

import pytest

from benchmark import counts
from benchmark.harness import BENCH, ROOT, cell_of, entry_module, load_spec, metric_reader

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(
        re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_only_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_uniqueness():
    groups = [SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


def test_every_cell_reports_enough():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for name in CELLS:
        cell = cell_of(SPEC, name)
        mine = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in mine and m["moves"] in e2e


def test_configurations_lie_under_paths_and_are_used():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_are_found_by_name(name):
    cell = cell_of(SPEC, name)
    assert hasattr(entry_module(cell), "Entry")
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"]))
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_every_traffic_names_an_entry():
    for path in (BENCH / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        assert hasattr(entry_module(types.SimpleNamespace(traffic=traffic)), "Entry"), path


def test_every_metric_file_belongs_to_a_metric():
    files = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert files == {m["name"] for m in SPEC["per_layer"]}


def test_k1w_bound_at_fullres128():
    n, L = 1088 * 1920, 128
    assert n == 2088960
    assert counts.k1w_bytes(n, L, 2) == 5 * n * L * 2 + L * L * 2
    assert round(counts.k1w_bound_s(n, L, 2) * 1e6, 1) == 798.2
    assert round(counts.k1w_bound_s(n, L, 4) * 1e6, 1) == 1596.4


def test_frame_least_bytes():
    assert counts.frame_least_bytes(1088, 1920, 128, 5, 2) == 5_397_872_640
    assert counts.frame_least_bytes(288, 384, 16, 5, 2) == 38_043_648
    # at fullres128 the frame is bound by its bytes, not by its products
    assert counts.frame_least_s(1088, 1920, 128, 5, 2) == pytest.approx(
        5_397_872_640 / 3.35e12)
