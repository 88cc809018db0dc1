"""LSH-based approximate Gaussian filtering, an alternative to the lattice
(counterpart of the JAX package's `ops/lsh.py`).

Approximates out_i = Σ_j exp(−‖ref_i − ref_j‖²/2)·src_j by restricting j
to locality-sensitive-hash candidates and weighting the survivors with the
exact Gaussian. For each of `num_tables` random-projection hashes the
points are sorted by bucket id, and each point's candidates are a fixed
window of its sorted neighbours that share its bucket. The union over the
tables is deduplicated by weight: each candidate's weight is divided by the
number of times it appears in the row. The self term is added exactly.

The work is in two parts: `bucket_ids` draws the projections (a CPU
`torch.Generator`, so a CPU and a GPU run hash alike) and
`lsh_filter_from_buckets` assembles and weights the candidates of given
bucket ids. Memory is O(n·K²) with K = num_tables·window (the
multiplicity count compares every pair of a row's candidates), as in the
JAX package: a 453 MB boolean tensor at 288×384 with the defaults.
"""
from __future__ import annotations

import torch

__all__ = ["bucket_ids", "lsh_filter_from_buckets", "lsh_gaussian_filter"]


def bucket_ids(ref: torch.Tensor, r: float, num_tables: int, seed: int = 0) -> torch.Tensor:
    """(num_tables, n) int32 hashes floor((a·v + b)/r) of the (n, d)
    features, a ~ N(0, I) and b ~ U[0, r) per table. The projection is
    taken in float64, so that a point's bucket does not hang on how a
    device rounds a float32 product at a bucket's edge."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(num_tables, ref.shape[1], generator=g, dtype=torch.float64)
    b = torch.rand(num_tables, 1, generator=g, dtype=torch.float64) * r
    proj = (ref.double() @ a.T.to(ref.device)).T + b.to(ref.device)
    return torch.floor(proj / r).to(torch.int32)


def lsh_filter_from_buckets(src: torch.Tensor, ref: torch.Tensor, buckets: torch.Tensor,
                            window: int) -> torch.Tensor:
    """The filter of (n, L) `src` over the candidates of (T, n) `buckets`:
    per table a window of `window` sorted neighbours (stable sort by
    bucket), the same-bucket ones kept; returns (n, L)."""
    T, n = buckets.shape
    dev = src.device
    offsets = torch.arange(-(window // 2), window - window // 2, device=dev)
    iota = torch.arange(n, device=dev)
    cands = []
    for row in buckets:
        order = torch.argsort(row, stable=True)
        pos_of = torch.empty_like(order).scatter_(0, order, iota)
        cand = order[(pos_of[:, None] + offsets[None, :]).clamp(0, n - 1)]  # (n, window)
        cands.append(torch.where(row[cand] == row[:, None], cand, -1))
    cands = torch.stack(cands, dim=1).reshape(n, T * window)

    # multiplicity of each (i, j) pair in row i's union, for the dedup
    mult = (cands[:, :, None] == cands[:, None, :]).sum(-1).to(src.dtype)
    valid = cands >= 0
    safe = cands.clamp_min(0)
    wts = torch.exp(-0.5 * ((ref[safe] - ref[:, None, :]) ** 2).sum(-1))
    keep = valid & (safe != iota[:, None])
    wts = torch.where(keep, wts / torch.clamp_min(mult, 1.0), 0.0)
    return torch.einsum("nk,nkl->nl", wts, src[safe]) + src


def lsh_gaussian_filter(src: torch.Tensor, ref: torch.Tensor, bucket_width: float = 2.0,
                        num_tables: int = 4, window: int = 16, seed: int = 0) -> torch.Tensor:
    """Approximate Gaussian filter of (n, L) `src` over (n, d) pre-scaled
    features by `num_tables` hash tables of bucket width `bucket_width`
    (in units of the feature σ), `window` candidates a point a table."""
    return lsh_filter_from_buckets(src, ref, bucket_ids(ref, bucket_width, num_tables, seed),
                                   window)
