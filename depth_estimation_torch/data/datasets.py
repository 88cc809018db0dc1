"""Stereo datasets: the Tsukuba pair (numpy on the host).

Counterpart of `TsukubaPair` in the JAX package's `data/datasets.py`. The pair's
directory comes from `DET_TSUKUBA_DIR`, read when a `TsukubaPair` is made.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.io import read_image, read_pgm

__all__ = ["TsukubaPair", "downsize_image"]


def _gauss1d(x: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    if sigma <= 0:
        return x
    r = max(1, int(np.ceil(3 * sigma)))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="reflect")
    out = np.zeros_like(x)
    for i, w in enumerate(k):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + x.shape[axis])
        out += w * xp[tuple(sl)]
    return out


def downsize_image(img: np.ndarray, factor: int) -> np.ndarray:
    """Anti-aliased integer downsizing: Gaussian blur (σ = factor/2), then
    stride slicing."""
    if factor <= 1:
        return img
    img = _gauss1d(_gauss1d(img, factor / 2.0, 0), factor / 2.0, 1)
    return img[::factor, ::factor]


@dataclass
class TsukubaPair:
    """The Tsukuba pair. GT convention: `truedisp` is 16× the true
    disparity at full resolution."""

    root: str = field(default_factory=lambda: os.environ.get("DET_TSUKUBA_DIR", ""))

    def available(self) -> bool:
        if not self.root:
            return False
        p = Path(self.root)
        return all(
            (p / f).exists() for f in ("imL.png", "imR.png", "truedisp.row3.col3.pgm")
        )

    def load(self, downsize: int = 1):
        p = Path(self.root)
        left = read_image(p / "imL.png")
        right = read_image(p / "imR.png")
        gt = read_pgm(p / "truedisp.row3.col3.pgm").astype(np.float64) / 16.0
        if downsize > 1:
            left = downsize_image(left, downsize)
            right = downsize_image(right, downsize)
            gt = gt[::downsize, ::downsize] / downsize
        return {"left": left, "right": right, "disparity": gt}
