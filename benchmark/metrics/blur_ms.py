"""Device time of the lattice's blurs a frame of one large frame at a time:
ms of the kernels launched inside the program's span `lattice.blur` over
the traced slice, ÷ its frames."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "lattice.blur")
