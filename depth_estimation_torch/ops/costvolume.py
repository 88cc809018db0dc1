"""Stereo matching cost volumes (counterpart of
the JAX package's `ops/costvolume.py`).

Disparity d means pixel (i, j) of the left image matches (i, j − d) of the
right; out-of-frame comparisons see zeros; costs are summed over a ws × ws
window, with scipy's reflect boundary (`agg_mode='reflect'`) or a plain
zero-padded window sum (`agg_mode='zero'`).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .boxfilter import box_filter

__all__ = [
    "absolute_difference",
    "cost_volume",
    "disparity_estimate",
    "expected_disparity",
    "local_contrast_normalize",
]


def absolute_difference(a, b):
    return (a - b).abs()


def local_contrast_normalize(img: torch.Tensor, window: int | None = None,
                             eps: float = 1e-6) -> torch.Tensor:
    """Local (or, with `window=None`, global) contrast normalization."""
    if window is None:
        mean = img.mean(dim=(0, 1), keepdim=True)
        diff = img - mean
        std = (diff ** 2).mean(dim=(0, 1), keepdim=True).sqrt()
    else:
        r = window // 2
        mean = box_filter(box_filter(img, r, 0), r, 1)
        diff = img - mean
        std = box_filter(box_filter(diff ** 2, r, 0), r, 1).sqrt()
    return diff / (std + eps)


def _symmetric_pad2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Pad axes 0 and 1 by r, repeating the edge pixel (numpy's
    'symmetric'; PyTorch's 'reflect' skips the edge and differs)."""
    x = torch.cat([x[:r].flip(0), x, x[-r:].flip(0)], dim=0)
    return torch.cat([x[:, :r].flip(1), x, x[:, -r:].flip(1)], dim=1)


def cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disp: int,
    window_size: int = 9,
    criterion: Callable = absolute_difference,
    agg_mode: str = "reflect",
) -> torch.Tensor:
    """(h, w, num_disp) aggregated matching cost (the CRF unaries E0) of an
    (h, w, c) rectified pair."""
    h, w, c = left.shape
    padded = F.pad(right, (0, 0, num_disp, 0))  # zeros left of column 0
    costs = [
        criterion(left, padded[:, num_disp - d: num_disp - d + w]).sum(-1)
        for d in range(num_disp)
    ]
    vol = torch.stack(costs, dim=-1)
    r = window_size // 2
    if agg_mode == "reflect":
        if r == 0:
            return vol
        vol = _symmetric_pad2d(vol, r)
        vol = box_filter(box_filter(vol, r, 0, normalize=False), r, 1, normalize=False)
        return vol[r:-r, r:-r]
    if agg_mode != "zero":
        raise ValueError(f"unknown agg_mode {agg_mode!r}")
    return box_filter(box_filter(vol, r, 0, normalize=False), r, 1, normalize=False)


def disparity_estimate(energy: torch.Tensor) -> torch.Tensor:
    """Winner-take-all disparity: argmin over the label axis."""
    return energy.argmin(dim=-1)


def expected_disparity(logits: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax-expectation decode: Σ_l softmax(logits)_l · label_l."""
    probs = torch.softmax(logits, dim=-1)
    if labels is None:
        labels = torch.arange(logits.shape[-1], dtype=logits.dtype, device=logits.device)
    return probs @ labels
