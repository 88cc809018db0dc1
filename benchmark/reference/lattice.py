"""A plain permutohedral-lattice Gaussian filter (Adams, Baek & Davis 2010).

    filter(src, pos)_i ≈ Σ_j exp(-‖pos_i − pos_j‖²/2) · src_j

Embed each position in the lattice, splat its value onto the d+1 vertices
of its enclosing simplex with barycentric weights, blur the occupied
vertices along each of the d+1 lattice axes with the unnormalised
[1/2, 1, 1/2] kernel (an absent neighbour counts as zero), and slice back
with the same weights, scaled by 1/(1 + 2^-d). This is the semantics the
program's lattice states (unnormalised, occupied vertices only); here it
is written as directly as PyTorch allows, in float64 unless told
otherwise, with no capacity, no tiles and no kernels. It imports nothing
of the program.

`values` and `weights`, where given, round tensors as a lower-precision
implementation would: `values` the source and the vertex values after the
splat and after each blur pass, `weights` the barycentric weights.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Lattice", "filter_with_grad"]


def _embedding_matrix(d: int) -> np.ndarray:
    """(d+1, d): elevated = E @ position, onto the hyperplane Σx = 0 of
    R^(d+1), scaled so that the lattice's blur approximates a unit Gaussian
    (Adams, Baek & Davis's recurrence, column by column)."""
    scale = (d + 1) * math.sqrt(2.0 / 3.0)
    sf = [scale / math.sqrt((i + 1) * (i + 2)) for i in range(d)]
    E = np.zeros((d + 1, d))
    for j in range(d):
        p = np.zeros(d)
        p[j] = sf[j]
        E[d, j] = -d * p[d - 1]
        for i in range(d - 1, 0, -1):
            E[i, j] = E[i + 1, j] - i * p[i - 1] + (i + 2) * p[i]
        E[0, j] = E[1, j] + 2 * p[0]
    return E


class Lattice:
    """The lattice of (n, d) positions: each position's d+1 vertices
    (`slot`, indices into the V occupied vertices) and weights (`bary`),
    and each vertex's two neighbours along each axis (`nbr`, V = none)."""

    def __init__(self, pos: torch.Tensor, dtype=torch.float64, rnd=None):
        """The embedding is computed in `pos`'s own dtype, so that a
        float32 configuration's positions pick the vertices a float32
        implementation picks (a position within rounding of a simplex's
        face may otherwise take another vertex, of zero weight, and with it
        another blur); the weights are then held and applied in `dtype`.
        `rnd`, where given, rounds the embedding's operands (a matrix
        product in a lower precision)."""
        rnd = rnd or (lambda x: x)
        n, d = pos.shape
        dev = pos.device
        self.d, self.dtype = d, dtype
        E = torch.as_tensor(_embedding_matrix(d), dtype=pos.dtype, device=dev)
        el = (rnd(E) @ rnd(pos).T).T  # (n, d+1)
        # the nearest point of the lattice (d+1)Z^(d+1) coordinate by coordinate
        inv = 1.0 / (d + 1)
        v = el * inv
        down, up = torch.floor(v) * (d + 1), torch.ceil(v) * (d + 1)
        rem0 = torch.where(up - el < el - down, up, down)
        total = torch.div(rem0.sum(1), d + 1, rounding_mode="floor").long()  # (n,)
        # rank of each coordinate's differential, descending, ties to the lower index
        diff = el - rem0
        k = torch.arange(d + 1, device=dev)
        greater = diff[:, None, :] > diff[:, :, None]  # [i, a, b]: diff_b > diff_a
        tie = (diff[:, None, :] == diff[:, :, None]) & (k[None, :] < k[:, None])[None]
        rank = (greater | tie).sum(2) + total[:, None]
        # walk back onto the plane Σ = 0
        high, low = rank >= d + 1, rank < 0
        rem0 = rem0 - (d + 1) * high + (d + 1) * low
        rank = rank - (d + 1) * high + (d + 1) * low
        # barycentric weights
        t = (el - rem0) * inv
        b = torch.zeros(n, d + 2, dtype=pos.dtype, device=dev)
        b.scatter_add_(1, d - rank, t)
        b.scatter_add_(1, d + 1 - rank, -t)
        b[:, 0] += 1.0 + b[:, d + 1]
        self.bary = b[:, : d + 1].to(dtype)  # (n, d+1)
        # the vertex of remainder r: rem0 + r, less (d+1) where rank > d − r;
        # the last coordinate is implied by Σ = 0 and left out of the key
        r = torch.arange(d + 1, device=dev)
        keys = (rem0.long()[:, None, :d] + r[None, :, None]
                - (d + 1) * (rank[:, None, :d] > d - r[None, :, None]))  # (n, d+1, d)
        self.V, self.slot, self.nbr = self._index(keys.reshape(-1, d), n, d)

    @staticmethod
    def _index(keys: torch.Tensor, n: int, d: int):
        """Occupied vertices by a sort of the keys packed into int64, and
        their neighbours ±(1, …, 1, −d at j, 1, …) and ±(1, …, 1) by binary search."""
        lo = keys.amin(0) - (d + 2)
        span = (keys.amax(0) + (d + 2) - lo + 1).tolist()
        if sum(math.log2(s) for s in span) >= 62:
            raise ValueError(f"lattice coordinate ranges {span} do not fit an int64 key")
        stride = [1] * d
        for c in range(d - 2, -1, -1):
            stride[c] = stride[c + 1] * span[c + 1]
        st = torch.as_tensor(stride, device=keys.device)
        packed = ((keys - lo) * st).sum(1)
        uniq, inverse = torch.unique(packed, return_inverse=True)
        V = uniq.shape[0]
        eye = torch.eye(d, dtype=torch.long, device=keys.device)
        deltas = torch.cat([1 - (d + 1) * eye, torch.ones(1, d, dtype=torch.long,
                                                           device=keys.device)])  # (d+1, d)
        nbr = []
        for sign in (1, -1):
            q = uniq[None, :] + sign * (deltas * st).sum(1)[:, None]  # (d+1, V)
            at = torch.searchsorted(uniq, q).clamp_max(V - 1)
            nbr.append(torch.where(uniq[at] == q, at, V))
        return V, inverse.reshape(n, d + 1), torch.stack(nbr, 1)  # (d+1, 2, V)

    def apply(self, src: torch.Tensor, reverse: bool = False, values=None,
              weights=None) -> torch.Tensor:
        """(n, L) → (n, L) in the lattice's dtype; `reverse` blurs the axes
        in the opposite order (the transposed filter)."""
        keep = values or (lambda x: x)
        src = keep(src.to(self.dtype))
        bary = (weights or (lambda x: x))(self.bary)
        n, L = src.shape
        vals = torch.zeros(self.V + 1, L, dtype=self.dtype, device=src.device)
        for r in range(self.d + 1):
            vals.index_add_(0, self.slot[:, r], bary[:, r, None] * src)
        vals[self.V] = 0
        vals = keep(vals)
        axes = range(self.d, -1, -1) if reverse else range(self.d + 1)
        for j in axes:
            blurred = vals[: self.V] + 0.5 * (vals[self.nbr[j, 0]] + vals[self.nbr[j, 1]])
            vals = keep(torch.cat([blurred, vals[self.V:]]))
        out = torch.zeros(n, L, dtype=self.dtype, device=src.device)
        for r in range(self.d + 1):
            out += bary[:, r, None] * vals[self.slot[:, r]]
        return out / (1.0 + 2.0 ** (-self.d))


class _Filter(torch.autograd.Function):
    """The lattice filter with the gradients of the Gaussian it stands
    for: ∂src is the transposed filter; with W_ij = exp(-‖p_i − p_j‖²/2),
    ∂p_i = −[s_i·p_i (Wg)_i − s_i·(W(g⊗p))_i + g_i·p_i (Ws)_i − g_i·(W(s⊗p))_i]
    summed over the values, each W a filter through the same lattice."""

    @staticmethod
    def forward(ctx, src, pos, lattice):
        ctx.lattice = lattice
        ctx.save_for_backward(src, pos)
        return lattice.apply(src)

    @staticmethod
    def backward(ctx, g):
        src, pos = ctx.saved_tensors
        lat = ctx.lattice
        n, L = src.shape
        d = pos.shape[1]
        gp = g[..., None] * pos[:, None, :]
        sp = src[..., None] * pos[:, None, :]
        wg, wgp = lat.apply(g), lat.apply(gp.reshape(n, L * d)).reshape(n, L, d)
        ws, wsp = lat.apply(src), lat.apply(sp.reshape(n, L * d)).reshape(n, L, d)
        grad_pos = -(sp * wg[..., None] - src[..., None] * wgp
                     + gp * ws[..., None] - g[..., None] * wsp).sum(1)
        return lat.apply(g, reverse=True), grad_pos, None


def filter_with_grad(src: torch.Tensor, pos: torch.Tensor, embed: torch.Tensor,
                     rnd=None) -> torch.Tensor:
    """The filter of (n, L) values over (n, d) positions, differentiable in
    both, through the lattice of `embed` (the same positions as the
    configuration computes them, in its dtype), held in `pos`'s dtype."""
    return _Filter.apply(src, pos, Lattice(embed.detach(), pos.dtype, rnd))
