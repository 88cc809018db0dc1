"""Memory accounting (counterpart of the JAX package's `utils/memory.py`):
a census of the live tensors found by the garbage collector, grouped by
device and dtype, and the CUDA caching allocator's counters per device."""
from __future__ import annotations

import gc
from collections import defaultdict

import torch

__all__ = ["live_array_report", "device_memory_stats", "format_bytes"]


def format_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024:
            return f"{b:.2f} {unit}"
        b /= 1024
    return f"{b:.2f} TiB"


def _live_tensors():
    # type(), unlike isinstance, reads no `__class__` attribute, which some
    # objects compute (deprecation shims, weak proxies)
    return (obj for obj in gc.get_objects() if issubclass(type(obj), torch.Tensor))


def live_array_report(print_fn=print, top: int = 20) -> dict:
    """Live tensors by device: {device: {'bytes', 'count', 'dtypes':
    {dtype: bytes}}}, where a tensor counts its own elements (a view
    counts again what its base holds). Prints the `top` largest tensors
    and the totals."""
    per_device = defaultdict(lambda: {"bytes": 0, "count": 0, "dtypes": defaultdict(int)})
    entries = []
    for t in _live_tensors():
        nbytes = t.numel() * t.element_size()
        dev, dtype = str(t.device), str(t.dtype).removeprefix("torch.")
        per_device[dev]["bytes"] += nbytes
        per_device[dev]["count"] += 1
        per_device[dev]["dtypes"][dtype] += nbytes
        entries.append((nbytes, tuple(t.shape), dtype, dev))
    entries.sort(reverse=True)
    if print_fn:
        print_fn(f"{len(entries)} live tensors")
        for nbytes, shape, dtype, dev in entries[:top]:
            print_fn(f"  {format_bytes(nbytes):>12}  {dtype:<10} {shape} @ {dev}")
        for dev, s in per_device.items():
            print_fn(f"TOTAL {dev}: {format_bytes(s['bytes'])} in {s['count']} tensors ("
                     + ", ".join(f"{k} {format_bytes(v)}" for k, v in s["dtypes"].items()) + ")")
    return {dev: {**s, "dtypes": dict(s["dtypes"])} for dev, s in per_device.items()}


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` of every CUDA device (empty without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
