"""The share of the mean-field updates that K1 computed, in the traced
slice: 100 × the program's counter `meanfield.update.K1` ÷ its counter
`meanfield.update` (the program counts only while a profiler records).
Nothing where nothing was traced, no update was counted, or the program
keeps no such counters."""


def read(run):
    if run.trace is None:
        return None
    try:
        from depth_estimation_torch.utils.profiling import counter_totals
    except ImportError:  # a program without counters
        return None
    c = counter_totals()
    if not c.get("meanfield.update"):
        return None
    return 100.0 * c.get("meanfield.update.K1", 0) / c["meanfield.update"]
