"""K1's share of its roofline: its least time at the frame's state
(`counts.k1w_bound_s`, the same work as K1w's) over its mean device time
a launch in the traced slice (`readers.update_roofline_pct`). Nothing
where the trace holds no launch of it."""
import re

from benchmark.readers import update_roofline_pct

# K1's kernel, as the profiler names it (`csrc/meanfield.cu`), as a whole
# name: K1w's and K1x's kernels (`fused_energy_update_wide_kernel`, ...)
# are not K1's
KERNEL = re.compile(r"(?<![A-Za-z0-9_])fused_energy_update_kernel(?![A-Za-z0-9_])")


def read(run):
    return update_roofline_pct(run, KERNEL.search)
