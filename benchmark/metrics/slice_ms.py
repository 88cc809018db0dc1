"""Device time of the lattice's slices a frame of one large frame at a time
(the fused loop's shifted bf16 message included): ms of the kernels
launched inside the program's span `lattice.slice` over the traced slice,
÷ its frames."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "lattice.slice")
