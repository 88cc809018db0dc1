"""Brute-force dense Gaussian filter — the O(n²) oracle (counterpart of
the JAX package's `ops/dense_gaussian.py`).

    filter(src, ref)_i = Σ_j exp(-‖ref_i − ref_j‖²/(2·variance)) · src_j

(j = i included). Row-blocked, so only a (block × n) tile of the n×n
matrix exists at a time; ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b makes each tile one
matmul.
"""
from __future__ import annotations

import torch

__all__ = ["dense_gaussian_filter", "dense_gaussian_adjacency", "dense_gaussian_matrix",
           "gaussian_weights_normalized", "affinity_row"]


def dense_gaussian_matrix(ref: torch.Tensor, variance: float = 1.0) -> torch.Tensor:
    """Full n×n matrix W_ij = exp(-‖ref_i − ref_j‖²/(2·variance)). Small n only."""
    sq = ((ref[None, :, :] - ref[:, None, :]) ** 2).sum(-1)
    return torch.exp(-0.5 * sq / variance)


def dense_gaussian_filter(src: torch.Tensor, ref: torch.Tensor, block: int = 1024,
                          variance: float = 1.0) -> torch.Tensor:
    """(n, L) values filtered with the Gaussian affinity of (n, d) features."""
    ref_sq = (ref ** 2).sum(-1)
    out = []
    for i in range(0, ref.shape[0], block):
        ref_blk = ref[i: i + block]
        sq = ref_sq[i: i + block, None] + ref_sq[None, :] - 2.0 * (ref_blk @ ref.T)
        w = torch.exp(-0.5 * sq.clamp_min(0.0) / variance)
        out.append(w @ src)
    return torch.cat(out, dim=0)


def dense_gaussian_adjacency(src: torch.Tensor, ref: torch.Tensor, **kw) -> torch.Tensor:
    """(W − I) @ src: the self-excluded message-passing operator."""
    return dense_gaussian_filter(src, ref, **kw) - src


def gaussian_weights_normalized(ref: torch.Tensor) -> torch.Tensor:
    """D^{-1/2} (W−I) D^{-1/2} − I with W_ij = exp(-‖ref_i−ref_j‖²) and D
    the degrees of W − I. Small n only (materializes n×n)."""
    n = ref.shape[0]
    eye = torch.eye(n, dtype=ref.dtype, device=ref.device)
    W = torch.exp(-((ref[None, :, :] - ref[:, None, :]) ** 2).sum(-1)) - eye
    dinv = 1.0 / torch.sqrt(W.sum(1))
    return dinv[:, None] * W * dinv[None, :] - eye


def affinity_row(ref: torch.Tensor, i, normalize: bool = True) -> torch.Tensor:
    """Row i of the affinity W[i, j] = exp(-‖ref_i − ref_j‖²), divided by
    sqrt(degree_i) when `normalize`."""
    a = torch.exp(-((ref - ref[i]) ** 2).sum(-1))
    if normalize:
        a = a / torch.sqrt((a.sum() - 1.0).clamp_min(1e-12))
    return a
