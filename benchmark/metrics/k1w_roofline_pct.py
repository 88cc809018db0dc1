"""K1w's share of its roofline: its least time at the frame's state
(`counts.k1w_bound_s`) over its mean device time a launch in the traced
slice (`readers.update_roofline_pct`). Nothing where the trace holds no
launch of it."""
from benchmark.readers import update_roofline_pct

# K1w's kernel, as the profiler names it (`csrc/meanfield_wide.cu`)
KERNEL_NAMES = ("fused_energy_update_wide_kernel",)


def read(run):
    return update_roofline_pct(run, lambda k: any(n in k for n in KERNEL_NAMES))
