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
    "squared_difference",
    "neg_product",
    "cost_volume",
    "disparity_badness",
    "disparity_estimate",
    "expected_disparity",
    "local_contrast_normalize",
    "ncc_template_disparity",
]


def absolute_difference(a, b):
    return (a - b).abs()


def squared_difference(a, b):
    return (a - b) ** 2


def neg_product(a, b):
    return -a * b


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


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each of the n + 2r positions of numpy's 'symmetric'
    padding by r: the edge repeats, and a pad longer than the side keeps
    reflecting (period 2n)."""
    p = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(p < n, p, 2 * n - 1 - p)


def _symmetric_pad2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Pad axes 0 and 1 by r as numpy's 'symmetric' does (PyTorch's
    'reflect' skips the edge pixel and differs)."""
    x = x.index_select(0, _symmetric_index(x.shape[0], r, x.device))
    return x.index_select(1, _symmetric_index(x.shape[1], r, x.device))


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


def disparity_badness(
    left: torch.Tensor,
    right: torch.Tensor,
    window_size: int = 9,
    criterion: Callable = absolute_difference,
    num_disp: int | None = None,
) -> torch.Tensor:
    """The cost volume over `w // 6` disparities (or `num_disp`)."""
    if num_disp is None:
        num_disp = left.shape[1] // 6
    return cost_volume(left, right, num_disp, window_size, criterion)


def disparity_estimate(energy: torch.Tensor) -> torch.Tensor:
    """Winner-take-all disparity: argmin over the label axis."""
    return energy.argmin(dim=-1)


def expected_disparity(logits: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax-expectation decode: Σ_l softmax(logits)_l · label_l."""
    probs = torch.softmax(logits, dim=-1)
    if labels is None:
        labels = torch.arange(logits.shape[-1], dtype=logits.dtype, device=logits.device)
    return probs @ labels


def ncc_template_disparity(img: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Template-match disparity by cross-correlation: the valid-mode
    correlation, channel by channel, of an (h, w, c) image with a flipped
    (th, tw, c) template, its norm over channels, and the column j of its
    first maximum, folded to min(j, w − j)."""
    w, c = img.shape[1], img.shape[2]
    # `conv2d` correlates, as the JAX package's `conv_general_dilated`
    # does, so the template is flipped here as it is there
    kern = template.flip(0, 1).permute(2, 0, 1)[:, None][:c]
    out = F.conv2d(img.permute(2, 0, 1)[None], kern, groups=c)[0]
    reduced = torch.linalg.vector_norm(out, dim=0)
    j = reduced.flatten().argmax() % reduced.shape[1]
    return torch.minimum(j, w - j)
