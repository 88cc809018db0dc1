"""Device time of the lattice's plan build a training step: ms of the
kernels launched inside the program's span `lattice.plan` over the traced
slice, ÷ its steps."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "lattice.plan")
