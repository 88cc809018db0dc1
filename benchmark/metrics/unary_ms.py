"""Device time of the unary a frame of one large frame at a time: the cost
volume and the unary's casts, ms of the kernels launched inside the
program's span `stereo.unary` over the traced slice, ÷ its frames."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "stereo.unary")
