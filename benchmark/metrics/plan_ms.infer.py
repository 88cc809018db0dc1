"""Device time of the lattice's plan build a frame of one large frame at a
time: ms of the kernels launched inside the program's span `lattice.plan`
over the traced slice, ÷ its frames."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "lattice.plan")
