"""Box filters by cumsum (counterpart of the JAX package's `ops/boxfilter.py`).

`box_filter` is an O(n) sliding-window sum (or edge-corrected mean) along
one axis: zero-pad, cumsum, difference. All functions keep the dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["box_filter", "box_filter2d", "window_counts"]


def window_counts(length: int, r: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Number of in-bounds taps of a radius-r window at each position."""
    i = np.arange(length)
    counts = np.minimum(i, r) + np.minimum(length - i - 1, r) + 1
    return torch.as_tensor(counts, dtype=dtype, device=device)


def box_filter(x: torch.Tensor, r: int, axis: int, normalize: bool = True) -> torch.Tensor:
    """Sliding-window sum (or mean) of width 2r+1 along `axis`, zero
    padding at the borders; `normalize=True` divides by the per-position
    in-bounds tap count."""
    axis = axis % x.ndim
    if r == 0:
        return x
    xt = x.movedim(axis, -1)
    csum = torch.cumsum(F.pad(xt, (r + 1, r)), dim=-1)
    out = (csum[..., 2 * r + 1:] - csum[..., : -(2 * r + 1)]).movedim(-1, axis)
    if normalize:
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        counts = window_counts(x.shape[axis], r, x.dtype, x.device)
        out = out / counts.reshape(shape)
    return out


def box_filter2d(x: torch.Tensor, r: int, axes: tuple[int, int] = (-2, -1),
                 normalize: bool = False) -> torch.Tensor:
    """Separable 2-D window sum/mean over a (2r+1)² window."""
    return box_filter(box_filter(x, r, axes[0], normalize), r, axes[1], normalize)
