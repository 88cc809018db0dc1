"""The reduction of a `torch.profiler` trace to what the per-layer metrics
and the result's `breakdown` read: the device's busy time (the union of
its kernel and copy intervals), its kernels by name, and its idle gaps by
what the host was doing meanwhile; and, apart, the device time of each
named range on the host's timeline (the program's spans)."""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import NamedTuple

__all__ = ["Trace", "reduce_events", "from_profiler", "spans_from_profiler", "idle_pct",
           "breakdown"]

_COPIES = ("Memcpy", "Memset")
_NAME_CHARS = 120


class Trace(NamedTuple):
    window_s: float  # the traced slice's length by the host clock
    busy_s: float  # the union of the device's activity intervals
    kernels: dict  # kernel name -> (launches, device seconds)
    copies_s: float  # device seconds of copies and sets
    idle_by_host: dict  # host op -> idle device seconds while it ran


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(device_events, host_events, window_s: float) -> Trace | None:
    """`device_events` and `host_events`: (name, start µs, end µs) on one
    timeline. None where the device did nothing."""
    if not device_events:
        return None
    kernels = defaultdict(lambda: [0, 0.0])
    copies = 0.0
    for name, a, b in device_events:
        if name.startswith(_COPIES):
            copies += (b - a) * 1e-6
        else:
            kernels[name][0] += 1
            kernels[name][1] += (b - a) * 1e-6
    busy = _merge([(a, b) for _, a, b in device_events])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # each gap between device intervals, from the first host event on,
    # charged to the innermost host op running at its midpoint
    start = min([a for _, a, _ in host_events] + [busy[0][0]])
    gaps = [(start, busy[0][0])] + [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    idle = defaultdict(float)
    hosts = sorted(host_events, key=lambda e: e[1])
    open_ops, k = [], 0  # a max-heap by start of the host ops begun so far
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while k < len(hosts) and hosts[k][1] <= mid:
            heapq.heappush(open_ops, (-hosts[k][1], hosts[k][2], hosts[k][0]))
            k += 1
        while open_ops and open_ops[0][1] < mid:  # ended: covers no later midpoint
            heapq.heappop(open_ops)
        idle[open_ops[0][2] if open_ops else "(no host op)"] += (b - a) * 1e-6
    return Trace(window_s, busy_s, {k: tuple(v) for k, v in kernels.items()}, copies,
                 dict(idle))


def from_profiler(prof, window_s: float) -> Trace | None:
    """The trace of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        (dev if e.device_type == DeviceType.CUDA else host).append(item)
    return reduce_events(dev, host, window_s)


def spans_from_profiler(prof) -> dict:
    """{name: (count, device seconds)} of the named ranges on the host's
    timeline of a finished `torch.profiler.profile`: each host-side event
    whose name is not one of PyTorch's operators (those hold a `::`), its
    `device_time_total` (the kernels and copies the profiler correlates
    with launches inside it, nested ranges' included) summed by name."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and "::" not in e.name:
            n, s = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, s + e.device_time_total * 1e-6)
    return out


def idle_pct(trace: Trace | None) -> float | None:
    """100 × (1 − busy ÷ window)."""
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device's most costly operations and the host ops under which it
    idled longest, each as [name, seconds]."""
    ops = sorted(((k[:_NAME_CHARS], v[1]) for k, v in trace.kernels.items()),
                 key=lambda kv: -kv[1])
    if trace.copies_s:
        ops = sorted(ops + [("(copies and sets)", trace.copies_s)], key=lambda kv: -kv[1])
    gaps = sorted(((k[:_NAME_CHARS], v) for k, v in trace.idle_by_host.items()),
                  key=lambda kv: -kv[1])
    return {"device_ops": [list(x) for x in ops[:top]],
            "idle_gaps": [list(x) for x in gaps[:top]]}
