"""Profiling: trace capture, stage timers, roofline accounting (counterpart
of the JAX package's `utils/profiling.py`).

- `trace(path)`: a context manager around `torch.profiler` that writes a
  Chrome trace of host and device activity to `path`.
- `StageTimer`: named wall-clock spans fenced by `torch.cuda.synchronize`
  on a GPU, so a span ends when its device work does.
- `roofline`: attained bandwidth and compute of a measured span against
  the published peaks of one NVIDIA H100 SXM (`H100_PEAK`).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from .device import resolve_device

__all__ = ["trace", "StageTimer", "roofline", "H100_PEAK"]

# NVIDIA's published figures for one H100 SXM at its 700 W limit (dense, no
# sparsity): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
# outside them, 3.35 TB/s of HBM3. A card set to a lower power limit
# reaches less.
H100_PEAK = {"flops_bf16": 989e12, "flops_f32": 67e12, "hbm_gbps": 3.35e12}


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


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageTimer:
    """Accumulating named spans on `device` (None: the GPU); every span and
    timed call ends with the device's work."""

    device: object = None
    spans: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        _fence(self.device)
        t0 = time.perf_counter()
        yield
        _fence(self.device)
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def time_fn(self, name: str, fn, *args, reps: int = 10):
        """Mean seconds of `fn(*args)` over `reps` calls after one warm-up."""
        out = fn(*args)
        _fence(self.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        _fence(self.device)
        self.spans[name] = (time.perf_counter() - t0) / reps
        return out

    def report(self, print_fn=print) -> dict:
        total = sum(self.spans.values())
        for name, s in sorted(self.spans.items(), key=lambda kv: -kv[1]):
            print_fn(f"{name:<28} {s * 1e3:9.3f} ms  ({100 * s / max(total, 1e-12):5.1f}%)")
        return self.spans


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
