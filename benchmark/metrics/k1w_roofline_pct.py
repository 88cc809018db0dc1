"""K1w's share of its roofline: its least time at the frame's state
(`counts.k1w_bound_s`, rows = the frame's pixels, the configuration's
state dtype) over its mean device time a launch in the traced slice.
Nothing where the trace holds no launch of it."""
from benchmark import counts

# K1w's kernel, as the profiler names it (`csrc/meanfield_wide.cu`)
KERNEL_NAMES = ("fused_energy_update_wide_kernel",)


def read(run):
    if run.trace is None:
        return None
    mine = [v for k, v in run.trace.kernels.items() if any(n in k for n in KERNEL_NAMES)]
    launches = sum(n for n, _ in mine)
    if not launches:
        return None
    seconds = sum(s for _, s in mine) / launches
    c = run.entry.program_state()
    cfg = run.cell.config
    h, w = cfg["height"], cfg["width"]
    if c.tile_px:
        h, w = h + (-h % c.tile_px), w + (-w % c.tile_px)
    elt = 2 if c.compute_dtype == "bf16" else 4
    return 100.0 * counts.k1w_bound_s(h * w, cfg["num_disp"], elt) / seconds
