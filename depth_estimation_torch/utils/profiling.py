"""Profiling: the program's spans and counters, trace capture, roofline
accounting (counterpart of the JAX package's `utils/profiling.py`).

- `span(name)`: a named range around one layer of the program, as a
  context manager or a decorator. It records only while a torch profiler
  records (`torch.profiler.profile`, `trace` below); otherwise it is one
  flag test and a shared null context, with no allocation, no CUDA call
  and no sync. While on, it is a FUNCTION-scope profiler range: a host
  event on the profiler's own timeline, which Kineto mirrors to no device
  event (unlike `record_function`'s user annotations), and to which the
  profiler correlates the kernels launched inside it (on autograd's
  thread too).
- `span_totals(prof)`: per span name in a finished profile, its count,
  host seconds and device seconds (the kernels and copies launched inside
  it, nested spans' included, as the profiler correlates them; none
  without a device).
- `count(name, value)`: a counter under the same on/off rule; `value` may
  be a device tensor, held unresolved until `counter_totals` reads it, so
  counting adds no sync. It keeps every value of a profiled run until
  `reset_counters`.
- `trace(path)`: the operator's exporter: a context manager around
  `torch.profiler` that writes a Chrome trace of host and device activity,
  the program's spans above the kernels, to `path`.
- `roofline`: attained bandwidth and compute of a measured span against
  the published peaks of one NVIDIA H100 SXM (`H100_PEAK`).
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "span_totals", "count", "counter_totals", "reset_counters", "trace",
           "roofline", "H100_PEAK"]

# NVIDIA's published figures for one H100 SXM at its 700 W limit (dense, no
# sparsity): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
# outside them, 3.35 TB/s of HBM3. A card set to a lower power limit
# reaches less.
H100_PEAK = {"flops_bf16": 989e12, "flops_f32": 67e12, "hbm_gbps": 3.35e12}

_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class _Null:
    """What a span is while no profiler records: a null context, and a
    decorator whose every call runs inside `span(name)`, decided at the
    call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _RecordFunctionFast(name):
                return fn(*args, **kwargs)

        return wrapped


class _On(_Null):
    """A span while a profiler records: a FUNCTION-scope profiler range."""

    __slots__ = ("_range",)

    def __enter__(self):
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False


# every span's name, with its shared null context
_NAMES: dict[str, _Null] = {}
# counter name -> the numbers and tensors counted, unresolved
_COUNTS: dict[str, list] = {}


def span(name: str):
    """A named range of the program: a context manager, or a decorator
    whose every call runs inside one. It records only while a torch
    profiler records; otherwise it is a null context shared by every call
    with that name."""
    null = _NAMES.get(name)
    if null is None:
        null = _NAMES[name] = _Null(name)
    # the flag torch sets as a profiler starts and clears as it stops
    if _autograd_profiler._is_profiler_enabled:
        return _On(name)
    return null


def span_totals(prof) -> dict:
    """{name: {"count", "host_s", "device_s"}} of the program's spans in the
    finished torch profiler `prof`: host seconds between each span's ends,
    device seconds of what the profiler correlates with launches inside
    it (0 where it traced no device)."""
    out = {}
    for e in prof.events():
        if e.name in _NAMES and e.device_type == torch.autograd.DeviceType.CPU:
            t = out.setdefault(e.name, {"count": 0, "host_s": 0.0, "device_s": 0.0})
            t["count"] += 1
            t["host_s"] += e.cpu_time_total * 1e-6
            t["device_s"] += e.device_time_total * 1e-6
    return out


def count(name: str, value) -> None:
    """Add `value` (a number, or a tensor read once `counter_totals` is
    called) to the counter `name`, while a torch profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS.setdefault(name, []).append(value)


def counter_totals() -> dict:
    """{name: sum} of every counter since the last `reset_counters`; reads
    the tensors counted (a wait for each)."""
    return {k: sum(v.item() if isinstance(v, torch.Tensor) else v for v in vs)
            for k, vs in _COUNTS.items()}


def reset_counters() -> None:
    """Empty the counters."""
    _COUNTS.clear()


@contextlib.contextmanager
def trace(path: str):
    """Profile the block (CPU, and CUDA where present) and export a Chrome
    trace to `path` (open it in chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


def roofline(seconds: float, bytes_moved: float, flops: float = 0.0,
             peaks: dict = H100_PEAK) -> dict:
    """Attained bandwidth and compute, and their fractions of the peaks, for
    a measured span."""
    bw = bytes_moved / max(seconds, 1e-12)
    fl = flops / max(seconds, 1e-12)
    return {
        "gbps": bw / 1e9,
        "hbm_fraction": bw / peaks["hbm_gbps"],
        "tflops": fl / 1e12,
        "flops_fraction_f32": fl / peaks["flops_f32"],
    }
