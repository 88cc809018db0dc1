"""`lattice_kernel_pct` in the cells whose rate is `frames_per_s.narrow`: its
reader, under a name that moves that rate."""
from benchmark.harness import metric_reader

read = metric_reader("lattice_kernel_pct")
