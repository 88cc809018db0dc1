"""Guided filter family, the O(n) edge-aware W of the trainable CRF
(counterpart of the JAX package's `ops/guided_filter.py`).

Per-pixel affine coefficients y ≈ A·x + b over (2r+1)² windows, from
cumsum box filters: the exact (c_x × c_x) regularized solve or the diagonal
approximation; the fast variant computes them at 1/s resolution and
upsamples them (nearest, half-pixel centres); the adjacency scales the
filter by 0.5(2r+1)² and subtracts the identity. The trainable regularizer
is softplus(omega), one per guide channel. Layout: channels-last (h, w, c).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .boxfilter import box_filter2d

__all__ = [
    "guided_filter_coeffs",
    "guided_filter",
    "fast_guided_filter",
    "guided_adjacency",
    "guided_adjacency_init",
    "guided_adjacency_apply",
]


def _box_mean(x: torch.Tensor, r: int, N: torch.Tensor) -> torch.Tensor:
    return box_filter2d(x, r, axes=(0, 1)) / N


def guided_filter_coeffs(y: torch.Tensor, x: torch.Tensor, r: int, eps,
                         exact: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Window-mean coefficients (mean_A (h, w, c_y, c_x), mean_b (h, w, c_y))
    of y (h, w, c_y) on the guide x (h, w, c_x); `eps` a scalar or (c_x,).
    `exact` solves (cov_xx + εI) Aᵀ = cov_yxᵀ per pixel; otherwise the
    per-channel variance stands in for cov_xx."""
    h, w, c_y = y.shape
    c_x = x.shape[-1]
    N = box_filter2d(torch.ones(h, w, 1, dtype=x.dtype, device=x.device), r, axes=(0, 1))
    mean_x = _box_mean(x, r, N)
    mean_y = _box_mean(y, r, N)
    yx = (y[..., :, None] * x[..., None, :]).reshape(h, w, c_y * c_x)
    cov_yx = (_box_mean(yx, r, N).reshape(h, w, c_y, c_x)
              - mean_y[..., :, None] * mean_x[..., None, :])
    eps = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
    if exact:
        xx = (x[..., :, None] * x[..., None, :]).reshape(h, w, c_x * c_x)
        cov_xx = (_box_mean(xx, r, N).reshape(h, w, c_x, c_x)
                  - mean_x[..., :, None] * mean_x[..., None, :])
        eye = torch.eye(c_x, dtype=x.dtype, device=x.device)
        reg = cov_xx + eye * (eps * torch.ones(c_x, dtype=x.dtype, device=x.device))
        A = torch.linalg.solve(reg[..., None, :, :], cov_yx[..., :, :, None])[..., 0]
    else:
        var_x = _box_mean(x * x, r, N) - mean_x ** 2
        A = cov_yx / (var_x[..., None, :] + eps)
    b = mean_y - torch.einsum("hwyx,hwx->hwy", A, mean_x)
    mean_A = _box_mean(A.reshape(h, w, c_y * c_x), r, N).reshape(h, w, c_y, c_x)
    return mean_A, _box_mean(b, r, N)


def guided_filter(y: torch.Tensor, x: torch.Tensor, r: int, eps) -> torch.Tensor:
    """Edge-aware filtering of y guided by x (He et al.)."""
    mean_A, mean_b = guided_filter_coeffs(y, x, r, eps)
    return torch.einsum("hwyx,hwx->hwy", mean_A, x) + mean_b


def _resize_nearest(img: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(h, w, c) → (hw, c), nearest with half-pixel centres."""
    return F.interpolate(img.permute(2, 0, 1)[None], size=hw,
                         mode="nearest-exact")[0].permute(1, 2, 0)


def fast_guided_filter(y: torch.Tensor, x: torch.Tensor, r: int, eps,
                       subsample: int = 2) -> torch.Tensor:
    """Coefficients at 1/s resolution with radius r//s (at least 1),
    upsampled and applied at full resolution."""
    h, w, c_y = y.shape
    c_x = x.shape[-1]
    lo = (h // subsample, w // subsample)
    mean_A_lo, mean_b_lo = guided_filter_coeffs(
        _resize_nearest(y, lo), _resize_nearest(x, lo), max(r // subsample, 1), eps)
    mean_A = _resize_nearest(mean_A_lo.reshape(lo + (c_y * c_x,)), (h, w)).reshape(h, w, c_y, c_x)
    return torch.einsum("hwyx,hwx->hwy", mean_A, x) + _resize_nearest(mean_b_lo, (h, w))


def guided_adjacency(src: torch.Tensor, guide: torch.Tensor, r: int, eps,
                     subsample: int = 2) -> torch.Tensor:
    """W@src with the guided-filter adjacency: filter(src)·0.5(2r+1)² − src."""
    return fast_guided_filter(src, guide, r, eps, subsample) * (0.5 * (2 * r + 1) ** 2) - src


def guided_adjacency_init(channels: int = 1, eps: float = 1e-5, dtype=torch.float32,
                          device=None) -> dict:
    """Trainable {'omega': (channels,)} = softplus⁻¹(eps) on `device`
    (None: the GPU)."""
    omega = float(np.log(np.expm1(eps)))
    return {"omega": torch.full((channels,), omega, dtype=dtype, device=resolve_device(device),
                                requires_grad=True)}


def guided_adjacency_apply(params: dict, src: torch.Tensor, guide: torch.Tensor, r: int,
                           subsample: int = 2) -> torch.Tensor:
    return guided_adjacency(src, guide, r, F.softplus(params["omega"]), subsample)
