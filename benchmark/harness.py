"""One run of one cell: set-up, warm-up, the measured window, the traced
slices, the comparison with the plain reference, and the result.

Everything a cell is made of is found by name, so that a new cell is new
data: `BENCHMARK.json` names the cell's configuration and traffic, which
are `configs/<config>.json` and `traffic/<traffic>.json`; the traffic's
`entry` names the module of `entries/` that drives the program; each
per-layer metric is read by `metrics/<metric>.py`; the limits of the
comparison are `limits/<workload>.json`.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

import torch

from . import counts, trace as T

__all__ = ["BENCH", "ROOT", "Cell", "Reading", "load_spec", "make_cell", "cell_of", "entry_module",
           "run_units", "run_cell", "forbidden_modules", "end_to_end_value"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# modules that nothing the benchmark runs may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "depth_estimation_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the metrics of BENCHMARK.json this cell reports untraced
    per_layer: list  # those it reports traced
    limits: dict  # the comparison's numbers and their limits


@dataclass
class Reading:
    """What a per-layer metric reads: the cell, the entry after its run,
    the traced slice's trace (None where nothing was traced), the units of
    that slice and of the sync-counting slice after it (as many), the
    latter's count of syncs, and the traced slice's named ranges
    (`trace.spans_from_profiler`: name -> (count, device seconds); None
    where nothing was traced)."""

    cell: Cell
    entry: object
    trace: T.Trace | None
    traced_units: int
    syncs: int | None
    spans: dict | None = None


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(*parts: str) -> dict:
    return json.loads(BENCH.joinpath(*parts).read_text())


def make_cell(name: str, config: str, traffic: str, chips: int = 1, end_to_end=(),
              per_layer=()) -> Cell:
    """A cell from its files: configs/<config>.json, traffic/<traffic>.json
    and limits/<name>.json."""
    return Cell(name, _json("configs", f"{config}.json"), _json("traffic", f"{traffic}.json"),
                chips, list(end_to_end), list(per_layer), _json("limits", f"{name}.json"))


def cell_of(spec: dict, workload: str) -> Cell:
    """The cell `workload` of BENCHMARK.json, with its files read."""
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return make_cell(workload, w["config"], w["traffic"], w["chips"], e2e, per_layer)


def entry_module(cell: Cell):
    return importlib.import_module(f"{__package__}.entries.{cell.traffic['entry']}")


def metric_reader(name: str):
    """`read` of metrics/<name>.py (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def end_to_end_value(values: dict, name: str) -> float:
    """An end-to-end metric's number among what a run measured: the one of
    its name, or else the one of its name less its last `.<part>`, so that
    `frames_per_s.narrow` is a cell's `frames_per_s` held to a bound of its
    own."""
    return values[name] if name in values else values[name.rsplit(".", 1)[0]]


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_units(entry, first: int, count: int, seconds: float | None = None):
    """Run units from index `first`: `count` of them, or as many as start
    within `seconds`. Returns (start, end, latencies, units, failed)."""
    lat, failed, i = [], 0, first
    t_start = t = time.perf_counter()
    while (i - first < count) if seconds is None else (t < t_start + seconds):
        try:
            entry.unit(i)
        except Exception as exc:  # a unit that raises counts as failed; nothing is retried
            failed += entry.frames_per_unit
            if failed == entry.frames_per_unit:
                _log(f"unit {i} raised: {type(exc).__name__}: {exc}")
        i += 1
        now = time.perf_counter()
        lat.append(now - t)
        t = now
    return t_start, t, lat, i - first, failed


def _traced(entry, first: int, count: int, device):
    """The trace of `count` units under `torch.profiler`, its named ranges,
    and the units' failures."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        failed = run_units(entry, first, count)[-1]
        _sync(device)
        window_s = time.perf_counter() - t0
    return T.from_profiler(prof, window_s), T.spans_from_profiler(prof), failed


def _count_syncs(entry, first: int, count: int, device):
    """The operations that made the host wait for the card over `count`
    units (`torch.cuda.set_sync_debug_mode('warn')`'s warnings; None off
    the card), and their failures."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            failed = run_units(entry, first, count)[-1]
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    if device.type != "cuda":
        return None, failed
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught), failed


def _card(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}


def _power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """One run of `cell` on `device`, `t0` the process's start by
    `time.perf_counter`. Returns the result line's object."""
    device = torch.device(device)
    mod = entry_module(cell)
    t_entry = time.perf_counter()
    entry = mod.Entry(cell.config, cell.traffic, seed, device)
    t_warm = time.perf_counter()
    entry.warm()
    _sync(device)
    t_window = time.perf_counter()
    setup_s = t_window - t0
    _log(f"set-up: {t_entry - t0:.3f} s to the entry, {t_warm - t_entry:.3f} s in it "
         f"({entry.timings}), {t_window - t_warm:.3f} s of warm-up")

    t_start, t_end, lat, units, failed = run_units(entry, entry.next_unit, 0, seconds)
    entry.next_unit += units
    attempted = units * entry.frames_per_unit
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    trace = syncs = spans = None
    traced_units = cell.traffic["trace_units"]
    if traced:
        _log("card:", _power_line(), "| peaks:", json.dumps(counts.PEAK))
        trace, spans, f1 = _traced(entry, entry.next_unit, traced_units, device)
        _log("spans (count, device s) over", traced_units, "units:",
             json.dumps({k: v for k, v in spans.items() if v[1]}))
        entry.next_unit += traced_units
        syncs, f2 = _count_syncs(entry, entry.next_unit, traced_units, device)
        entry.next_unit += traced_units
        attempted += 2 * traced_units * entry.frames_per_unit
        failed += f1 + f2
    failed += entry.failed()

    if traced:
        reading = Reading(cell, entry, trace, traced_units, syncs, spans)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **entry.end_to_end(t_end - t_start, lat, units)}
        metrics = {m["name"]: {"value": end_to_end_value(values, m["name"]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    _log(f"window: {units} units in {t_end - t_start:.3f} s after {setup_s:.3f} s of set-up; "
         f"{failed} of {attempted} failed; {entry.summary()}")

    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.check()
    _log("compared:", json.dumps(entry.detail))
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": cell.limits[k]}
              for k in cell.limits}
    correct = (failed == 0 and set(numbers) == set(cell.limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    device_info = {**_card(device, cell.chips), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if traced and trace is not None:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        out["breakdown"] = T.breakdown(trace)
    out["checks"] = checks
    return out


def p95(values: list[float]) -> float:
    """The 95th percentile, interpolated between order statistics."""
    return statistics.quantiles(values, n=20, method="inclusive")[18]
