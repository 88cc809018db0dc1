"""The share of the cost volume's calls in the traced slice that the
hand-written kernel served: 100 × the program's counter
`costvolume.kernel` ÷ its counter `costvolume.calls` (the program counts
only while a profiler records). Nothing where nothing was traced, no call
was counted, or the program keeps no such counters."""


def read(run):
    if run.trace is None:
        return None
    try:
        from depth_estimation_torch.utils.profiling import counter_totals
    except ImportError:  # a program without counters
        return None
    c = counter_totals()
    if not c.get("costvolume.calls"):
        return None
    return 100.0 * c.get("costvolume.kernel", 0) / c["costvolume.calls"]
