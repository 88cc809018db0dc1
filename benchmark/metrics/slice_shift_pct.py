"""The share of the mean-field updates whose message the lattice apply's
slice wrote shifted and in bf16 itself, in the traced slice: 100 × the
program's counter `lattice.slice.shifted` ÷ its counter `meanfield.update`
(the program counts only while a profiler records). Nothing where nothing
was traced, no update was counted, or the program has no shifted slice."""


def read(run):
    if run.trace is None:
        return None
    try:
        from depth_estimation_torch.ops.cuda.lattice import slice_untiled_shifted  # noqa: F401
        from depth_estimation_torch.utils.profiling import counter_totals
    except ImportError:  # a program without counters or without the shifted slice
        return None
    c = counter_totals()
    if not c.get("meanfield.update"):
        return None
    return 100.0 * c.get("lattice.slice.shifted", 0) / c["meanfield.update"]
