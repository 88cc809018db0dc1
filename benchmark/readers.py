"""What the per-layer metrics of several cells compute alike; each metric's
file in `metrics/` reads its own cells through one of these."""
from __future__ import annotations

from .trace import idle_pct

__all__ = ["idle_pct", "syncs_per_frame", "kernels_per_frame"]


def syncs_per_frame(run) -> float | None:
    """Operations that made the host wait for the card, per frame of the
    sync-counting slice, less the client's own fetch of each result."""
    if run.syncs is None:
        return None
    return (run.syncs - run.traced_units) / (run.traced_units * run.entry.frames_per_unit)


def kernels_per_frame(run) -> float | None:
    """Kernels the card ran per frame of the traced slice (copies and sets
    not counted)."""
    if run.trace is None:
        return None
    launches = sum(n for n, _ in run.trace.kernels.values())
    return launches / (run.traced_units * run.entry.frames_per_unit)
