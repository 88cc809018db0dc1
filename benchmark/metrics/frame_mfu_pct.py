"""The whole frame's share of the card's peak: the least time of one frame
(`counts.frame_least_s`: the mean-field state read and written once an
iteration and the images read once, at the HBM peak, or the
compatibility products at the bf16 peak, whichever is longer) over the
traced slice's time per frame."""
from benchmark import counts


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    elt = 2 if run.entry.program_state().compute_dtype == "bf16" else 4
    least = counts.frame_least_s(cfg["height"], cfg["width"], cfg["num_disp"], cfg["niters"],
                                 elt)
    per_frame = run.trace.window_s / (run.traced_units * run.entry.frames_per_unit)
    return 100.0 * least / per_frame
