"""Instance-mask-guided depth: per-object disparity compositing
(counterpart of the JAX package's `models/maskdepth.py`).

Given (K, h, w) instance masks from any detector, one disparity per object
by FFT phase correlation over the masked images, painted into a segment-wise
disparity map in mask order.
"""
from __future__ import annotations

import torch

__all__ = ["phase_correlation_offset", "masked_phase_disparity", "composite_mask_depth"]


def phase_correlation_offset(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Horizontal shift between two (h, w, c) images by phase correlation:
    the argmax of the normalized cross-power spectrum's inverse (summed
    over channels by the L2 norm), its column folded to min(j, w − j)."""
    I1 = torch.fft.fft2(img1, dim=(0, 1))
    I2 = torch.fft.fft2(img2, dim=(0, 1))
    cross = I1.conj() * I2
    corr = torch.fft.ifft2(cross / (cross.abs() + 1e-4), dim=(0, 1)).real
    j = torch.linalg.vector_norm(corr, dim=2).argmax() % img1.shape[1]
    return torch.minimum(j, img2.shape[1] - j)


def masked_phase_disparity(left: torch.Tensor, right: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Disparity of one object: phase correlation of the masked images."""
    m = mask[..., None].to(left.dtype)
    return phase_correlation_offset(left * m, right * m).to(left.dtype)


def composite_mask_depth(left: torch.Tensor, right: torch.Tensor, masks: torch.Tensor,
                         background: float = 0.0) -> torch.Tensor:
    """(h, w) segment-wise disparity from (K, h, w) masks; where masks
    overlap, the later (higher-index) one wins."""
    canvas = torch.full(left.shape[:2], background, dtype=left.dtype, device=left.device)
    for mask in masks:
        canvas = torch.where(mask > 0, masked_phase_disparity(left, right, mask), canvas)
    return canvas
