"""Multi-process parallelism over `torch.distributed`: a (data, tile) mesh of
ranks, halo-exchanged row stripes and the row-striped stereo pipeline.

The JAX package's `data_sharding` and `replicated` (sharding specs) have
no counterpart: the port moves the data instead, with `shard_batch` (a
rank's slice of a batch) and `broadcast_` (rank 0's tensors to all).
"""
from .mesh import Mesh, all_mean_, broadcast_, make_mesh, shard_batch  # noqa: F401
from .tiling import halo_exchange_rows, tiled_apply, tiled_filter_hwc  # noqa: F401
from .stereo_tiled import crf_stereo_infer_tiled  # noqa: F401
