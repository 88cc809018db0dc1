"""The share of the lattice's untiled applies whose splat and slice both
ran the hand-written kernels, in the traced slice: 100 × the program's
counter `lattice.apply.kernel` ÷ its counter `lattice.apply.untiled` (the
program counts only while a profiler records). Nothing where nothing was
traced, no untiled apply was counted, or the program keeps no such
counters."""


def read(run):
    if run.trace is None:
        return None
    try:
        from depth_estimation_torch.utils.profiling import counter_totals
    except ImportError:  # a program without counters
        return None
    c = counter_totals()
    if not c.get("lattice.apply.untiled"):
        return None
    return 100.0 * c.get("lattice.apply.kernel", 0) / c["lattice.apply.untiled"]
