"""Box filters by cumsum and Gaussian blurs (counterpart of the JAX
package's `ops/boxfilter.py`).

`box_filter` is an O(n) sliding-window sum (or edge-corrected mean) along
one axis: zero-pad, cumsum, difference. `gaussian_blur` is a normalised
truncated Gaussian along one axis, differentiable in σ; `gaussian_blur_box`
approximates it by iterated box means. All functions keep the dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["box_filter", "box_filter2d", "window_counts", "gaussian_blur",
           "box_radius_for_sigma", "gaussian_blur_box"]


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


def _gauss_kernel(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    offsets = torch.arange(-radius, radius + 1, dtype=sigma.dtype, device=sigma.device)
    w = torch.exp(-0.5 * (offsets / sigma) ** 2)
    return w / w.sum()


def gaussian_blur(x: torch.Tensor, sigma, axis: int, radius: int | None = None) -> torch.Tensor:
    """Normalised Gaussian blur along one axis, zero padding, differentiable
    in σ (a float or a tensor that may require grad). `radius` is the
    truncation half-width; it defaults to ceil(3σ), at least 1."""
    axis = axis % x.ndim
    if radius is None:
        radius = max(1, int(math.ceil(3 * float(sigma))))
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    kernel = _gauss_kernel(sigma, radius)
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - axis)] = pad[2 * (x.ndim - 1 - axis) + 1] = radius
    padded = F.pad(x, pad)
    n = x.shape[axis]
    out = torch.zeros_like(x)
    for k in range(2 * radius + 1):  # in the JAX package's order of taps
        out = out + kernel[k] * padded.narrow(axis, k, n)
    return out


def box_radius_for_sigma(sigma: float, niters: int = 3) -> int:
    """Box half-width such that `niters` box passes approximate a Gaussian
    of standard deviation σ."""
    return int(math.floor(math.sqrt(12 * sigma ** 2 / niters + 1)) // 2)


def gaussian_blur_box(x: torch.Tensor, sigma: float, axis: int, niters: int = 3) -> torch.Tensor:
    """Approximate Gaussian blur by `niters` iterated box means; σ is a
    number (the box radius is fixed by it). Costs O(n·niters) whatever σ."""
    r = box_radius_for_sigma(float(sigma), niters)
    for _ in range(niters):
        x = box_filter(x, r, axis, normalize=True)
    return x
