"""Multi-process parallelism over `torch.distributed`: a (data, tile) mesh of
ranks, halo-exchanged row stripes and the row-striped stereo pipeline."""
