"""Compute primitives (cost volume, box filter, lattice, dense oracle, ...).

The names that the JAX package's `ops` re-exports, from their leaf modules,
but one: `guided_filter` stays the module `ops.guided_filter` (its function
of that name is `ops.guided_filter.guided_filter`), so that importing the
module is never shadowed by the function. `spectral_embedding` and
`spectral_segment` load at first use: `ops.spectral` builds on
`models.pipeline`, which imports `ops`.
"""
from .boxfilter import box_filter, box_filter2d, gaussian_blur, gaussian_blur_box  # noqa: F401
from .costvolume import (  # noqa: F401
    cost_volume,
    disparity_badness,
    disparity_estimate,
    expected_disparity,
    ncc_template_disparity,
)
from .dense_gaussian import dense_gaussian_adjacency, dense_gaussian_filter  # noqa: F401
from .detection import iou_matrix, nms, roi_align, roi_pool_max  # noqa: F401
from .guided_filter import fast_guided_filter, guided_adjacency  # noqa: F401
from .lsh import lsh_gaussian_filter  # noqa: F401
from .permutohedral import (  # noqa: F401
    apply_plan,
    build_plan,
    lattice_adjacency,
    lattice_filter,
    lattice_filter_batched,
    lattice_filter_planned,
)

_LAZY = {"spectral_embedding": "spectral", "spectral_segment": "spectral"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
