"""Device time of the lattice's splats a frame of one large frame at a time:
ms of the kernels launched inside the program's span `lattice.splat` over
the traced slice, ÷ its frames."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "lattice.splat")
