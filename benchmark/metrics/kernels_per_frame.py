"""Kernels the card ran per frame of one large frame at a time in the
traced slice (copies and sets not counted), from `torch.profiler`'s
device activity."""
from benchmark.readers import kernels_per_frame


def read(run):
    return kernels_per_frame(run)
