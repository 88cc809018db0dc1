"""Device time of the lattice's backward a training step (the ∂src and ∂ref
applies): ms of the kernels launched inside the program's span
`lattice.backward` over the traced slice, ÷ its steps."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "lattice.backward")
