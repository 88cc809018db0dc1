"""Synthetic stereo frames made on the device from a seed.

The recipe is the port's `data/synthetic.make_stereo_pair` (and its
`random_texture`), rewritten so that a whole pool of pairs is drawn by a
`torch.Generator` on the card: textured fronto-parallel rectangles at
distinct disparities over a textured zero-disparity background, the right
view made by shifting each layer left by its disparity (nearer layers
painted last), disocclusions filled with a fresh background texture. The
images are then squeezed to `contrast` around 0.5. The same seed on the
same device gives the same pool.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Pool", "random_texture", "make_pool"]


class Pool(NamedTuple):
    left: torch.Tensor  # (P, h, w, 3) float32
    right: torch.Tensor  # (P, h, w, 3) float32
    gt: torch.Tensor  # (P, h, w) float32 disparity of the left view, 0 = background


def random_texture(gen: torch.Generator, b: int, h: int, w: int, device) -> torch.Tensor:
    """(b, h, w, 3) smooth random textures in [0, 1] with speckle, each
    normalised by its own range, as `random_texture` makes one."""
    img = torch.rand(b, h, w, 3, generator=gen, device=device)
    for _ in range(3):
        img = 0.25 * (img.roll(1, 1) + img.roll(-1, 1) + img.roll(1, 2) + img.roll(-1, 2))
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    img = (img - lo) / (hi - lo + 1e-9)
    return 0.8 * img + 0.2 * torch.rand(b, h, w, 3, generator=gen, device=device)


def make_pool(seed: int, size: int, h: int, w: int, num_layers: int, max_disp: int,
              contrast: float, device) -> Pool:
    """`size` pairs of (h, w) frames with `num_layers` layers at distinct
    disparities drawn from 1..max_disp."""
    if not 1 <= num_layers <= max_disp:
        raise ValueError(f"need 1 <= num_layers={num_layers} <= max_disp={max_disp}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    left = random_texture(gen, size, h, w, device)
    # each pair's disparities: num_layers distinct values of 1..max_disp, ascending
    disps = torch.rand(size, max_disp, generator=gen, device=device).argsort(1)[:, :num_layers] + 1
    disps = disps.sort(1).values
    # each layer's height, width and corner, drawn as numpy's randint would
    u = torch.rand(size, num_layers, 4, generator=gen, device=device)
    disps, u = disps.tolist(), u.tolist()
    gt = torch.zeros(size, h, w, device=device)
    for p in range(size):
        for d, (a, b, c, e) in zip(disps[p], u[p]):
            lh = h // 4 + int(a * (h // 2 - h // 4))
            lw = w // 4 + int(b * (w // 2 - w // 4))
            i0, j0 = int(c * (h - lh)), int(e * (w - lw))
            left[p, i0:i0 + lh, j0:j0 + lw] = random_texture(gen, 1, lh, lw, device)[0]
            gt[p, i0:i0 + lh, j0:j0 + lw] = d
    right = random_texture(gen, size, h, w, device)  # the disocclusion fill
    for p in range(size):
        filled = torch.zeros(h, w, dtype=torch.bool, device=device)
        shifted = torch.zeros(h, w, 3, device=device)
        for d in [0] + disps[p]:  # far to near: nearer layers occlude
            src = gt[p, :, d:] == d
            dst_img = shifted[:, :w - d]
            dst_img[src] = left[p, :, d:][src]
            filled[:, :w - d] |= src
        right[p] = torch.where(filled[..., None], shifted, right[p])
    lo = 0.5 - contrast / 2
    return Pool(lo + contrast * left, lo + contrast * right, gt)
