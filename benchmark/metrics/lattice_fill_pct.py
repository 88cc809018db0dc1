"""The lattice's fill of one large frame at a time: the occupied vertex
slots over the plans' capacity, 100 × the program's counter
`lattice.vertices` (`plan.num_valid`) ÷ its counter `lattice.capacity`,
summed over the plans of the traced slice (the program counts only while
a profiler records). Nothing where nothing was traced or the program
keeps no such counters."""


def read(run):
    if run.trace is None:
        return None
    try:
        from depth_estimation_torch.utils.profiling import counter_totals
    except ImportError:  # a program without counters
        return None
    c = counter_totals()
    if not c.get("lattice.capacity") or "lattice.vertices" not in c:
        return None
    return 100.0 * c["lattice.vertices"] / c["lattice.capacity"]
