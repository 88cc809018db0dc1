"""K1x's share of its roofline: its least time at the frame's state
(`counts.k1w_bound_s`, the same work as K1w's: E0, S and C read, E and C'
written, Mu read; rows = the frame's pixels, the configuration's state
dtype) over its device time an update in the traced slice, the update's
Mu pass included. Nothing where the trace holds no launch of it."""
from benchmark import counts

# K1x's kernel and its Mu pass, as the profiler names them (`csrc/meanfield_xwide.cu`)
KERNEL = "fused_energy_update_xwide_kernel"
MU_PASS = "fused_energy_update_xwide_tile_mu_kernel"


def read(run):
    if run.trace is None:
        return None
    launches = sum(n for k, (n, _) in run.trace.kernels.items() if KERNEL in k)
    if not launches:
        return None
    seconds = sum(s for k, (_, s) in run.trace.kernels.items()
                  if KERNEL in k or MU_PASS in k) / launches
    c = run.entry.program_state()
    cfg = run.cell.config
    h, w = cfg["height"], cfg["width"]
    if c.tile_px:
        h, w = h + (-h % c.tile_px), w + (-w % c.tile_px)
    elt = 2 if c.compute_dtype == "bf16" else 4
    return 100.0 * counts.k1w_bound_s(h * w, cfg["num_disp"], elt) / seconds
