"""The cost volume kernel's share of its roofline: the layer's least time
(`least_bytes` at the HBM peak: both float32 (h, w, 3) images read once
and the float32 (h, w, L) volume written once, h and w padded to the
frame's tiles where the program tiles it) over the kernel's mean device
time a launch in the traced slice. Nothing where the trace holds no launch
of it."""
from benchmark import counts

# the kernel, as the profiler names it (`csrc/costvolume.cu`)
KERNEL = "costvolume_reflect_kernel"


def least_bytes(h: int, w: int, L: int) -> int:
    """Bytes any cost volume of an (h, w) frame at L labels moves: the two
    float32 3-channel images read once, the float32 volume written once."""
    return (2 * h * w * 3 + h * w * L) * 4


def read(run):
    if run.trace is None:
        return None
    mine = [v for k, v in run.trace.kernels.items() if KERNEL in k]
    launches = sum(n for n, _ in mine)
    if not launches:
        return None
    seconds = sum(s for _, s in mine) / launches
    c = run.entry.program_state()
    cfg = run.cell.config
    h, w = cfg["height"], cfg["width"]
    if c.tile_px:
        h, w = h + (-h % c.tile_px), w + (-w % c.tile_px)
    least_s = least_bytes(h, w, cfg["num_disp"]) / counts.PEAK["hbm_bytes_per_s"]
    return 100.0 * least_s / seconds
