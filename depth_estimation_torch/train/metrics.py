"""Disparity/depth metrics: EPE, bad-τ, masked L1/MSE (counterpart of
the JAX package's `train/metrics.py`)."""
from __future__ import annotations

import torch

__all__ = ["masked_l1", "masked_mse", "epe", "bad_pixel_ratio", "valid_mask"]


def valid_mask(gt: torch.Tensor, min_val: float = 0.0) -> torch.Tensor:
    """Validity mask: GT strictly above `min_val`."""
    return (gt > min_val).to(gt.dtype)


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (err * mask).sum() / mask.sum().clamp_min(1.0)


def masked_l1(pred, gt, mask=None) -> torch.Tensor:
    mask = valid_mask(gt) if mask is None else mask
    return _masked_mean((pred - gt).abs(), mask)


def masked_mse(pred, gt, mask=None) -> torch.Tensor:
    mask = valid_mask(gt) if mask is None else mask
    return _masked_mean((pred - gt) ** 2, mask)


def epe(pred, gt, mask=None) -> torch.Tensor:
    """End-point error = masked mean absolute disparity error."""
    return masked_l1(pred, gt, mask)


def bad_pixel_ratio(pred, gt, tau: float = 2.0, mask=None) -> torch.Tensor:
    """Fraction of valid pixels with |error| > τ."""
    mask = valid_mask(gt) if mask is None else mask
    return _masked_mean(((pred - gt).abs() > tau).to(gt.dtype), mask)
