"""Device time of the fused mean-field updates a frame of one large frame at
a time (K1, K1w, K1x or K1xx): ms of the kernels launched inside the
program's span `meanfield.update` over the traced slice, ÷ its frames."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "meanfield.update")
