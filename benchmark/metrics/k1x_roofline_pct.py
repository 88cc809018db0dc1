"""K1x's share of its roofline: its least time at the frame's state
(`counts.k1w_bound_s`, the same work as K1w's) over its device time an
update in the traced slice, the update's Mu pass included
(`readers.update_roofline_pct`). Nothing where the trace holds no launch
of it."""
from benchmark.readers import update_roofline_pct

# K1x's kernel and its Mu pass, as the profiler names them (`csrc/meanfield_xwide.cu`)
KERNEL = "fused_energy_update_xwide_kernel"
MU_PASS = "fused_energy_update_xwide_tile_mu_kernel"


def read(run):
    return update_roofline_pct(run, lambda k: KERNEL in k,
                               lambda k: KERNEL in k or MU_PASS in k)
