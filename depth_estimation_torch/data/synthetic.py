"""Procedural synthetic stereo data — the CI/test fixture backend.

The reference's only self-contained test harness is the procedurally
generated shapes dataset (`Mask_RCNN/samples/shapes/shapes.py:63-191`,
SURVEY.md §4.6). This module plays the same role for the stereo/CRF
pipeline: random textured scenes composed of fronto-parallel layers, each
shifted horizontally by its (known) disparity to form the right view. No
downloads, fully deterministic per seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticStereo", "random_texture", "make_stereo_pair"]


def random_texture(rng: np.random.RandomState, h: int, w: int, smooth: int = 3) -> np.ndarray:
    """Smooth random RGB texture in [0,1] with enough high-frequency content
    for window matching."""
    img = rng.rand(h, w, 3)
    for _ in range(smooth):
        img = 0.25 * (
            np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        )
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    # add speckle so block matching is well-posed
    img = 0.8 * img + 0.2 * rng.rand(h, w, 3)
    return img


def make_stereo_pair(
    rng: np.random.RandomState,
    h: int = 64,
    w: int = 96,
    num_layers: int = 3,
    max_disp: int = 8,
):
    """Compose `num_layers` textured rectangles at increasing disparity over
    a zero-disparity background.

    Returns (left, right, disparity) with left/right (h, w, 3) float in
    [0,1] and disparity (h, w) float ground truth for the *left* view.
    """
    left = random_texture(rng, h, w)
    disp = np.zeros((h, w))
    disps = np.sort(rng.choice(np.arange(1, max_disp + 1), size=num_layers, replace=False))
    for d in disps:  # paint nearer (larger-d) layers last
        lh = rng.randint(h // 4, h // 2)
        lw = rng.randint(w // 4, w // 2)
        i0 = rng.randint(0, h - lh)
        j0 = rng.randint(0, w - lw)
        left[i0 : i0 + lh, j0 : j0 + lw] = random_texture(rng, lh, lw)
        disp[i0 : i0 + lh, j0 : j0 + lw] = d

    # Right view: pixel (i, j) of left appears at (i, j - d) in right.
    right = np.zeros_like(left)
    filled = np.zeros((h, w), bool)
    # paint far-to-near so nearer layers occlude
    order = np.argsort(disp, axis=None)  # far first
    for d in np.unique(disp):
        mask = disp == d
        ii, jj = np.nonzero(mask)
        jr = jj - int(d)
        ok = jr >= 0
        right[ii[ok], jr[ok]] = left[ii[ok], jj[ok]]
        filled[ii[ok], jr[ok]] = True
    # fill disocclusions with background texture
    bg = random_texture(rng, h, w)
    right[~filled] = bg[~filled]
    return left, right, disp


@dataclass
class SyntheticStereo:
    """Iterable dataset of synthetic stereo pairs.

    Each item: dict(left, right, disparity) as float64 numpy arrays.
    """

    num_items: int = 8
    h: int = 64
    w: int = 96
    max_disp: int = 8
    seed: int = 0

    def __len__(self):
        return self.num_items

    def __getitem__(self, idx: int):
        if not 0 <= idx < self.num_items:
            raise IndexError(idx)
        rng = np.random.RandomState(self.seed + idx)
        left, right, disp = make_stereo_pair(rng, self.h, self.w, max_disp=self.max_disp)
        return {"left": left, "right": right, "disparity": disp}
