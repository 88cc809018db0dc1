"""What the per-layer metrics of several cells compute alike; each metric's
file in `metrics/` reads its own cells through one of these."""
from __future__ import annotations

from . import counts
from .trace import idle_pct

__all__ = ["idle_pct", "syncs_per_frame", "kernels_per_frame", "span_ms", "update_roofline_pct"]


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


def span_ms(run, name: str) -> float | None:
    """Milliseconds of device time a frame (or a step) inside the program's
    span `name` over the traced slice: its device seconds ÷ (traced units ×
    frames a unit). Nothing where nothing was traced, the device ran
    nothing, or the slice holds no span of that name (a span the program
    renamed reads nothing, not 0)."""
    if run.trace is None or run.spans is None or name not in run.spans:
        return None
    return 1e3 * run.spans[name][1] / (run.traced_units * run.entry.frames_per_unit)


def update_roofline_pct(run, launched, timed=None) -> float | None:
    """A fused update kernel's share of its roofline: its least time at the
    frame's state (`counts.k1w_bound_s`: E0, S and C read, E and C'
    written, Mu read; rows = the frame's pixels, padded to the program's
    tiles; the configuration's state dtype) over its device time a launch
    in the traced slice. `launched` takes the names of the kernels whose
    launches count, `timed` those whose time counts (`launched`'s unless
    given: a pass that each launch brings with it). Nothing where nothing
    was traced or the trace holds no launch of it."""
    if run.trace is None:
        return None
    timed = timed or launched
    launches = sum(n for k, (n, _) in run.trace.kernels.items() if launched(k))
    if not launches:
        return None
    seconds = sum(s for k, (_, s) in run.trace.kernels.items() if timed(k)) / launches
    c = run.entry.program_state()
    cfg = run.cell.config
    h, w = cfg["height"], cfg["width"]
    if c.tile_px:
        h, w = h + (-h % c.tile_px), w + (-w % c.tile_px)
    elt = 2 if c.compute_dtype == "bf16" else 4
    return 100.0 * counts.k1w_bound_s(h * w, cfg["num_disp"], elt) / seconds
