"""Brute-force dense Gaussian filter — the O(n²) oracle (counterpart of
the JAX package's `ops/dense_gaussian.py`).

    filter(src, ref)_i = Σ_j exp(-‖ref_i − ref_j‖²/(2·variance)) · src_j

(j = i included). Row-blocked, so only a (block × n) tile of the n×n
matrix exists at a time; ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b makes each tile one
matmul.
"""
from __future__ import annotations

import torch

__all__ = ["dense_gaussian_filter"]


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
