"""Permutohedral-lattice Gaussian filtering in PyTorch (counterpart of
the JAX package's `ops/permutohedral.py`).

The O(n) approximation to dense Gaussian filtering
    filter(src, ref)_i = Σ_j exp(-‖ref_i − ref_j‖²/2) · src_j
(Adams, Baek, Davis 2010), split as in the JAX package into

  plan  = f(ref): embed → enclosing simplex → barycentric weights; vertex
          dedup by a stable lexicographic sort; blur neighbors by a
          sort-merge join of the neighbor-key queries against the unique
          keys; optional tiled incidence blocks (`tile`), built either from
          the general plan or by the lean per-tile batched sorts
          (`sort_mode='packed1'`);
  apply = splat (segment sum) → blur (d+1 passes of the unnormalized
          [1/2, 1, 1/2] kernel) → slice (barycentric recombine, scaled by
          1/(1+2^-d)).

Static-capacity semantics are the JAX package's: C = `max_vertices`
slots, slot C is the zero sentinel, vertices beyond C and entries of tiles
beyond `tile_u` soft-drop (counted by `num_valid` > C and
`tile_overflow`). Packed sort keys are int64, so a pinned 'packed1' raises
instead of wrapping when the ranges do not fit.

An untiled plan keeps its entries in slot order (`entry_order`,
`slot_start`: the dedup's sort order and segment heads, in int32;
`entry_weight`: their weights in that order; `chunk_start`: the splat
kernel's chunks of each slot). On the card its splat
and slice are the CUDA kernels of `ops/cuda/lattice.py`: the splat a
segmented reduce over those sorted entries into the (C+1, L) vertex table
in f32, the slice one gather of each pixel's d+1 rows. On the CPU they are
the plain versions: the splat sums by `index_add_` in f32 (the JAX
package's CSR boundary reduce computes the same sums in another order), the
slice takes d+1 gathers. The plan keeps no `band`.

`lattice_filter_planned` is differentiable in `src` and `ref` through a
`torch.autograd.Function`: ∂src is the transposed filter (the blur axes
in reverse), ∂ref the analytic 4-filter identity of the dense Gaussian,
both through the forward's plan.

While a torch profiler records, `build_plan`, the splat, blur and slice of
`apply_plan` and the filter's backward run inside the spans
`lattice.plan`, `lattice.splat`, `lattice.blur`, `lattice.slice` and
`lattice.backward`, each plan counts its occupied slots and capacity, and
`apply_plan` counts its untiled applies (`lattice.apply.untiled`), those
whose splat and slice both ran the kernels (`lattice.apply.kernel`) and
those that took the shifted bf16 slice (`lattice.slice.shifted`)
(`utils.profiling`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import count, span
from .cuda import lattice as _kernels

__all__ = [
    "PermutohedralPlan",
    "build_plan",
    "apply_plan",
    "simplex_embed",
    "rotation_matrices",
    "count_vertices",
    "suggest_capacity",
    "suggest_sort_mode",
    "suggest_tile_u",
    "lattice_filter_planned",
    "lattice_filter",
    "lattice_adjacency",
    "lattice_filter_batched",
    "batched_lattice_adjacency",
]

_I64 = torch.int64
# packed int64 sort keys keep one spare bit for the neighbor-delta arithmetic
_PACK_BITS = 62


# ---------------------------------------------------------------------------
# Embedding math
# ---------------------------------------------------------------------------


def _embedding_matrix(d: int) -> np.ndarray:
    """(d+1, d) matrix E with elevated = E @ position (scale factors
    (d+1)·sqrt(2/3)/sqrt((i+1)(i+2)) folded in). Rows sum to zero."""
    E = np.zeros((d + 1, d))
    scale = (d + 1) * math.sqrt(2.0 / 3.0)
    sf = np.array([scale / math.sqrt((i + 1) * (i + 2)) for i in range(d)])
    for j in range(d):
        p = np.zeros(d)
        p[j] = sf[j]
        elevated = np.zeros(d + 1)
        elevated[d] = -d * p[d - 1]
        for i in range(d - 1, 0, -1):
            elevated[i] = elevated[i + 1] - i * p[i - 1] + (i + 2) * p[i]
        elevated[0] = elevated[1] + 2 * p[0]
        E[:, j] = elevated
    return E


def _canonical_simplex(d: int) -> np.ndarray:
    """(d+1, d+1) canonical simplex offsets:
    canonical[r, j] = r for j ≤ d−r else r − (d+1)."""
    c = np.zeros((d + 1, d + 1), dtype=np.int64)
    for r in range(d + 1):
        c[r, : d + 1 - r] = r
        c[r, d + 1 - r:] = r - (d + 1)
    return c


def _simplex_embed_cols(ref: torch.Tensor):
    """Column-major simplex embedding of (n, d) features.

    Returns key_cols (d tensors of (d+1, n) int64: lattice coordinate k of
    simplex remainder r for pixel i at [r, i]) and bary_t ((d+1, n)
    barycentric weights, summing to 1 over axis 0)."""
    n, d = ref.shape
    dev = ref.device
    E = torch.as_tensor(_embedding_matrix(d), dtype=ref.dtype, device=dev)
    canonical = torch.as_tensor(_canonical_simplex(d), device=dev)

    elevated = E @ ref.T  # (d+1, n)
    # greedy nearest multiple-of-(d+1) point. Division by a constant is a
    # product with its reciprocal throughout, as XLA rewrites it, so that
    # keys and weights round as in the JAX package.
    inv = 1.0 / (d + 1)
    v = elevated * inv
    up = torch.ceil(v) * (d + 1)
    down = torch.floor(v) * (d + 1)
    greedy = torch.where(up - elevated < elevated - down, up, down).to(_I64)
    coord_sum = torch.div(greedy.sum(0), d + 1, rounding_mode="floor")

    # rank of the differential, descending, ties to the lower index:
    # rank[r] = #{r2 : diff[r2] > diff[r], or equal with r2 < r}
    diff = elevated - greedy
    a, b = diff[None, :, :], diff[:, None, :]  # [r, r2, i]
    before = torch.ones(d + 1, d + 1, dtype=torch.bool, device=dev).tril(-1)
    rank = ((a > b) | ((a == b) & before[:, :, None])).sum(1)

    # walk back onto the hyperplane
    rank_s = rank + coord_sum[None, :]
    too_high = rank_s >= d + 1
    too_low = rank_s < 0
    greedy = torch.where(too_high, greedy - (d + 1),
                         torch.where(too_low, greedy + (d + 1), greedy))
    rank = torch.where(too_high, rank_s - (d + 1),
                       torch.where(too_low, rank_s + (d + 1), rank_s))

    # barycentric coordinates: each t[k] lands at d − rank[k] and, negated,
    # at d + 1 − rank[k] (rank is a permutation, so each slot gets one of each)
    t = (elevated - greedy) * inv
    bary = torch.zeros(d + 2, n, dtype=t.dtype, device=dev)
    bary.scatter_add_(0, d - rank, t)
    bary.scatter_add_(0, d + 1 - rank, -t)
    bary[0] += 1.0 + bary[d + 1]
    bary_t = bary[: d + 1]

    key_cols = [greedy[k][None, :] + canonical[:, rank[k]] for k in range(d)]
    return key_cols, bary_t


def simplex_embed(ref: torch.Tensor):
    """(n, d+1, d) int64 vertex keys and (n, d+1) barycentric weights."""
    key_cols, bary_t = _simplex_embed_cols(ref)
    return torch.stack(key_cols, 0).permute(2, 1, 0), bary_t.T


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------


class PermutohedralPlan(NamedTuple):
    """Lattice plan — everything derived from `ref`.

    C = `neighbors.shape[1]` is the static vertex capacity; slot C is the
    zero sentinel for missing neighbors and capacity overflow. A lean tiled
    plan sets the entry-wise table `slot` to None and runs only through the
    tiled tables. An untiled plan keeps its entries in slot order, the
    table the splat kernel walks: `entry_order[slot_start[c]:slot_start[c +
    1]]` are slot c's entries in increasing order, `entry_weight` their
    weights; the overflow entries (slot C) lie past `slot_start[C]`. The
    splat kernel cuts each slot's entries into chunks of
    `ops/cuda/lattice.CHUNK`, a team a chunk: `chunk_start` numbers them,
    slot by slot."""

    slot: torch.Tensor | None  # (n, d+1) vertex slot per (pixel, remainder), ≤ C
    bary: torch.Tensor  # (n, d+1) barycentric weights
    neighbors: torch.Tensor  # (d+1, C, 2) blur neighbor slots (C = missing)
    num_valid: torch.Tensor  # () occupied slots (may exceed C: overflow)
    tile_A: torch.Tensor | None = None  # (T, P, U) dense barycentric blocks
    tile_vid: torch.Tensor | None = None  # (T, U) global slot per local id
    tile_overflow: torch.Tensor | None = None  # () entries dropped (tile > U)
    entry_order: torch.Tensor | None = None  # (N,) int32 entries e = r·n + i in slot order
    entry_weight: torch.Tensor | None = None  # (N,) their barycentric weights
    slot_start: torch.Tensor | None = None  # (C+1,) int32 first sorted entry of each slot
    chunk_start: torch.Tensor | None = None  # (C+1,) int32 first splat chunk of each slot

    @property
    def d(self) -> int:
        return self.neighbors.shape[0] - 1

    @property
    def capacity(self) -> int:
        return self.neighbors.shape[1]


def _pack(cols, widths):
    """Mixed-radix int64 key of non-negative columns (most significant
    first), given each column's exclusive upper bound."""
    key = cols[0]
    for c, w in zip(cols[1:], widths[1:]):
        key = key * w + c
    return key


def _sort_rows(cols, extras=(), mode: str = "auto"):
    """Stable lexicographic row argsort of parallel (N,) integer columns.

    'lex' runs one stable single-key sort per column, least significant
    first; 'packed1' sorts one mixed-radix int64 key; 'packed2' two keys,
    low then high. All three give the same order. 'auto' picks on the host
    from the measured column ranges; a pinned packed mode whose ranges do
    not fit int64 raises.

    Returns (order, row_changed, sorted_extras): `order[k]` is the row id
    of the k-th sorted row, `row_changed` (N-1,) marks sorted rows that
    differ from their predecessor, and the extras come permuted by order.
    """
    d = len(cols)
    shifted = [c - c.min() for c in cols]
    if d > 2 and mode != "lex":
        rng = [int(r) + 1 for r in torch.stack([s.max() for s in shifted]).tolist()]
        logr = [math.log2(r) for r in rng]
        m = (d + 1) // 2
        fits1 = sum(logr) < _PACK_BITS
        fits2 = sum(logr[:m]) < _PACK_BITS and sum(logr[m:]) < _PACK_BITS
        if mode == "auto":
            mode = "packed1" if fits1 else ("packed2" if fits2 else "lex")
        elif (mode == "packed1" and not fits1) or (mode == "packed2" and not fits2):
            raise ValueError(f"sort_mode={mode!r}: column ranges {rng} do not "
                             "fit the int64 packed key")
    else:
        mode = "lex"

    if mode == "packed1":
        keys, order = torch.sort(_pack(shifted, rng), stable=True)
        row_changed = keys[1:] != keys[:-1]
    elif mode == "packed2":
        k_hi, k_lo = _pack(shifted[:m], rng[:m]), _pack(shifted[m:], rng[m:])
        o1 = torch.sort(k_lo, stable=True).indices
        order = o1[torch.sort(k_hi[o1], stable=True).indices]
        hi, lo = k_hi[order], k_lo[order]
        row_changed = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    elif mode == "lex":
        order = torch.arange(cols[0].shape[0], device=cols[0].device)
        for k in range(d - 1, -1, -1):
            order = order[torch.sort(shifted[k][order], stable=True).indices]
        row_changed = None
        for s in shifted:
            ss = s[order]
            ch = ss[1:] != ss[:-1]
            row_changed = ch if row_changed is None else row_changed | ch
    else:
        raise ValueError(f"unknown sort_mode {mode!r}")
    return order, row_changed, tuple(e[order] for e in extras)


def _heads(row_changed: torch.Tensor) -> torch.Tensor:
    first = torch.ones(row_changed.shape[:-1] + (1,), dtype=torch.bool,
                       device=row_changed.device)
    return torch.cat([first, row_changed], dim=-1)


def _join(table_cols, query_cols, mode: str) -> torch.Tensor:
    """Sort-merge join: for each query row, the index of the table row with
    the same key, or -1. Table rows that real queries can hit must be
    unique.

    The stable sort of [table ∥ queries] puts the table row first in its
    run of equal keys; a segmented max of the row markers (table index, or
    -1 for queries) hands its index to every query of the run. Scattering
    by the sort order restores query order."""
    Ct = table_cols[0].shape[0]
    Q = query_cols[0].shape[0]
    dev = table_cols[0].device
    comb = [torch.cat([t, q]) for t, q in zip(table_cols, query_cols)]
    marker = torch.cat([torch.arange(Ct, device=dev),
                        torch.full((Q,), -1, dtype=_I64, device=dev)])
    order, row_changed, (m_s,) = _sort_rows(comb, (marker,), mode)
    run = torch.cumsum(_heads(row_changed), 0) - 1
    run_max = torch.full((Ct + Q,), -1, dtype=_I64, device=dev).scatter_reduce(
        0, run, m_s, reduce="amax")
    found = torch.empty(Ct + Q, dtype=_I64, device=dev).scatter_(0, order, run_max[run])
    return found[Ct:]


def _neighbor_deltas(d: int) -> np.ndarray:
    """(d+1, d) blur-neighbor key deltas: axis j < d is +1 everywhere
    except coord j, which gets −d; axis d is +1 in every stored coord."""
    eye = np.eye(d, dtype=np.int64)
    return np.stack([np.ones(d, np.int64) - (d + 1) * eye[j] for j in range(d)]
                    + [np.ones(d, np.int64)])


def _packed_delta(delta, strides) -> int:
    """A key delta as an offset of the mixed-radix packed key (exact)."""
    return sum(int(a) * s for a, s in zip(delta, strides))


def _neighbors(found: torch.Tensor, d: int, C: int) -> torch.Tensor:
    """(d+1, C, 2) neighbor slots from the join of the +delta queries then
    the −delta queries; absent neighbors point at the sentinel C."""
    found = torch.where(found < 0, C, found)
    return torch.stack([found[: (d + 1) * C].reshape(d + 1, C),
                        found[(d + 1) * C:].reshape(d + 1, C)], dim=-1)


def _incidence(u_pm: torch.Tensor, bary_pm: torch.Tensor, U: int, tile_bf16: bool):
    """(n, U) dense barycentric incidence: row i holds bary[i, r] at column
    u_pm[i, r]; local id U (dropped entries) lands in a discarded column."""
    A = torch.zeros(u_pm.shape[0], U + 1, dtype=bary_pm.dtype, device=u_pm.device)
    A.scatter_add_(1, u_pm, bary_pm)
    return A[:, :U].to(torch.bfloat16 if tile_bf16 else bary_pm.dtype)


def _counted(plan: PermutohedralPlan) -> PermutohedralPlan:
    """The plan, its occupied slots and its capacity counted (while a
    profiler records)."""
    count("lattice.vertices", plan.num_valid)
    count("lattice.capacity", plan.capacity)
    return plan


@span("lattice.plan")
def build_plan(
    ref: torch.Tensor,
    max_vertices: int | None = None,
    order_by_sum: bool = True,
    tile: int | None = None,
    tile_u: int = 512,
    tile_bf16: bool = False,
    sort_mode: str = "auto",
) -> PermutohedralPlan:
    """Build the lattice plan from (n, d) reference features.

    Args:
      max_vertices: static capacity C (default n·(d+1), the worst case).
      order_by_sum: prepend the coordinate sum as the most significant
        sort column (the same vertices in another slot order).
      tile, tile_u, tile_bf16: build the (T, P=tile, U=tile_u) incidence
        blocks of the tiled splat/slice (n % tile == 0), in bf16 if asked.
      sort_mode: 'auto' | 'packed1' | 'packed2' | 'lex'. 'packed1' with
        `tile` (order_by_sum False) takes the lean per-tile build.

    An untiled plan carries the entry table (`entry_order`, `entry_weight`,
    `slot_start`, `chunk_start`); a tiled one does not.
    """
    n, d = ref.shape
    if tile is not None and sort_mode == "packed1" and not order_by_sum:
        C_lean = n * (d + 1) if max_vertices is None else int(max_vertices)
        return _counted(_build_plan_tiled_lean(ref, C_lean, int(tile), int(tile_u), tile_bf16))
    dev = ref.device
    key_cols, bary_t = _simplex_embed_cols(ref)
    N = n * (d + 1)
    C = N if max_vertices is None else int(max_vertices)
    # entry id convention: entry = r·n + i (remainder-major)
    flat_cols = [kc.reshape(N) for kc in key_cols]
    if order_by_sum:
        flat_cols = [torch.stack(flat_cols).sum(0)] + flat_cols

    # --- 1) lexicographic dedup
    order, row_changed, _ = _sort_rows(flat_cols, mode=sort_mode)
    is_head = _heads(row_changed)
    seg = torch.cumsum(is_head, 0) - 1
    num_valid = seg[-1] + 1
    seg_capped = seg.clamp_max(C)
    slot = torch.empty(N, dtype=_I64, device=dev).scatter_(0, order, seg_capped)
    slot = slot.reshape(d + 1, n).T

    # --- 2) unique keys in slot order; invalid slots get a sentinel just
    # above the occupied range, which no neighbor query can equal
    dk = len(flat_cols)
    flat_rows = torch.stack(flat_cols, dim=-1)  # (N, dk)
    heads = torch.nonzero(is_head).squeeze(1)  # sorted position of each slot's first entry
    head_entry = order[heads[:C]]
    sent = torch.stack([c.max() for c in flat_cols]) + (d + 2)
    unique_keys = sent.expand(C, dk).clone()
    unique_keys[: head_entry.shape[0]] = flat_rows[head_entry]

    # --- 3) blur neighbors by a sort-merge join
    deltas = _neighbor_deltas(d)
    if order_by_sum:
        deltas = np.concatenate([deltas.sum(1, keepdims=True), deltas], axis=1)
    delta_arr = torch.as_tensor(deltas, device=dev)  # (d+1, dk)
    queries = torch.cat([
        (unique_keys[None] + delta_arr[:, None]).reshape(-1, dk),
        (unique_keys[None] - delta_arr[:, None]).reshape(-1, dk),
    ])
    neighbors = _neighbors(_join(list(unique_keys.T), list(queries.T), sort_mode), d, C)

    entries = {}
    if tile is None:
        # --- the entries in slot order for the splat kernel: slots past
        # the occupied ones start at N; slot_start[C] bounds slots < C
        slot_start = torch.full((C + 1,), N, dtype=torch.int32, device=dev)
        slot_start[: min(heads.shape[0], C + 1)] = heads[: C + 1].to(torch.int32)
        chunks = torch.div(slot_start[1:] - slot_start[:-1] + (_kernels.CHUNK - 1),
                           _kernels.CHUNK, rounding_mode="floor")
        chunk_start = torch.zeros(C + 1, dtype=torch.int32, device=dev)
        chunk_start[1:] = torch.cumsum(chunks, 0)
        entries = dict(entry_order=order.to(torch.int32), entry_weight=bary_t.reshape(N)[order],
                       slot_start=slot_start, chunk_start=chunk_start)

    tile_A = tile_vid = tile_overflow = None
    if tile is not None:
        # --- 4) tiled incidence tables: group entries by (tile, slot)
        P, U = int(tile), int(tile_u)
        if n % P != 0:
            raise ValueError(f"tile={P} must divide n={n}")
        T = n // P
        G_cap = T * U
        slot_pm = slot.reshape(N)  # pixel-major entries: e = i·(d+1) + r
        t_pix = torch.arange(n, device=dev) // P
        gkey = t_pix.repeat_interleave(d + 1) * (C + 1) + slot_pm
        sorted_gkey, sorted_eid = torch.sort(gkey, stable=True)
        ghead = _heads(sorted_gkey[1:] != sorted_gkey[:-1])
        g = torch.cumsum(ghead, 0) - 1  # group index per sorted entry
        heads_key = sorted_gkey[ghead][:G_cap]  # groups beyond capacity drop
        group_key = torch.full((G_cap,), (T + 1) * (C + 1), dtype=_I64, device=dev)
        group_key[: heads_key.shape[0]] = heads_key
        group_tile = group_key // (C + 1)
        group_slot = (group_key % (C + 1)).clamp_max(C)
        # first group of each tile; empty tiles inherit the next start
        tile_start = torch.searchsorted(group_tile, torch.arange(T + 1, device=dev))
        tile_sorted = sorted_gkey // (C + 1)
        u_sorted = g - tile_start[tile_sorted.clamp_max(T)]
        ok = (u_sorted >= 0) & (u_sorted < U) & (tile_sorted < T) & (g < G_cap)
        tile_overflow = (~ok).sum()
        u_entry = torch.empty(N, dtype=_I64, device=dev).scatter_(
            0, sorted_eid, torch.where(ok, u_sorted, U))
        tile_A = _incidence(u_entry.reshape(n, d + 1), bary_t.T, U,
                            tile_bf16).reshape(T, P, U)
        group_slot_pad = torch.cat([group_slot, torch.full((U,), C, dtype=_I64, device=dev)])
        iota_u = torch.arange(U, device=dev)
        ucount = (tile_start[1:] - tile_start[:-1])[:, None]
        tile_vid = torch.where(iota_u[None, :] < ucount,
                               group_slot_pad[tile_start[:T, None] + iota_u[None, :]], C)

    return _counted(PermutohedralPlan(
        slot=slot, bary=bary_t.T, neighbors=neighbors, num_valid=num_valid,
        tile_A=tile_A, tile_vid=tile_vid, tile_overflow=tile_overflow, **entries))


def _build_plan_tiled_lean(ref: torch.Tensor, C: int, P: int, U: int,
                           tile_bf16: bool) -> PermutohedralPlan:
    """Tiled plan from per-tile batched sorts over one packed key.

    1. pack the d key columns into one int64 with each range widened by
       ±(d+2), so every blur-neighbor delta is a fixed packed offset;
    2. per tile (a row of T × P·(d+1) entries), a stable sort by packed key
       gives segment heads and local vertex ids u, scattered back to entry
       order;
    3. the ≤ U group keys of each tile are deduped by one small global sort
       into global vertex ids (in packed, i.e. lexicographic, order);
    4. dense (P, U) incidence blocks, and the neighbor join in packed space.

    The packed key is computed in int64 from this frame's ranges; a frame
    whose ranges do not fit raises instead of wrapping.
    """
    n, d = ref.shape
    dev = ref.device
    if n % P != 0:
        raise ValueError(f"tile={P} must divide n={n}")
    T = n // P
    EPT = P * (d + 1)  # entries per tile
    if U > EPT:
        raise ValueError(f"tile_u={U} exceeds entries-per-tile {EPT}")
    key_cols, bary_t = _simplex_embed_cols(ref)

    # --- widened-range mixed-radix packed key (exact Python-int strides)
    marg = d + 2
    lim = torch.stack([torch.stack([c.min(), c.max()]) for c in key_cols]).tolist()
    mins = [lo for lo, _ in lim]
    rngs = [hi - lo + 1 + 2 * marg for lo, hi in lim]
    strides = [1] * d
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * rngs[k + 1]
    pds = [_packed_delta(dl, strides) for dl in _neighbor_deltas(d)]
    max_pd = max(abs(p) for p in pds)
    if strides[0] * rngs[0] + 2 * max_pd + 2 >= 2 ** _PACK_BITS:
        raise ValueError(f"lattice coordinate ranges {rngs} do not fit the "
                         "int64 packed key of the lean tiled plan")
    pk = sum((key_cols[k] - mins[k] + marg) * strides[k] for k in range(d))  # (d+1, n)
    pd_arr = torch.as_tensor(pds, dtype=_I64, device=dev)

    # --- per-tile grouping: column r·P + p of row t is (remainder r, pixel t·P+p)
    pk_t = pk.reshape(d + 1, T, P).permute(1, 0, 2).reshape(T, EPT)
    pk_s, le_s = torch.sort(pk_t, dim=1, stable=True)
    ghead = _heads(pk_s[:, 1:] != pk_s[:, :-1])
    u = torch.cumsum(ghead, 1) - 1  # local group id
    tile_overflow = (u >= U).sum()
    u_ok = u.clamp_max(U)  # U = dropped
    u_e = torch.empty_like(u_ok).scatter_(1, le_s, u_ok)
    u_pm = u_e.reshape(T, d + 1, P).permute(1, 0, 2).reshape(d + 1, n).T
    tile_A = _incidence(u_pm, bary_t.T, U, tile_bf16).reshape(T, P, U)

    # --- per-tile group keys, by local id; absent ids hold the sentinel
    SENT = pk_s[:, -1].max() + max_pd + 1
    col = torch.where(ghead, u_ok, U)
    tile_pk = SENT.expand(T, U + 1).clone().scatter_(1, col, pk_s)[:, :U]

    # --- global vertex ids: one small dedup over the T·U group keys
    fs, fi = torch.sort(tile_pk.reshape(T * U), stable=True)
    fhead = _heads(fs[1:] != fs[:-1])
    freal = fs < SENT
    vidseq = torch.cumsum(fhead, 0) - 1
    num_valid = (fhead & freal).sum()
    vid_sorted = torch.where(freal, vidseq.clamp_max(C), C)
    tile_vid = torch.empty(T * U, dtype=_I64, device=dev).scatter_(
        0, fi, vid_sorted).reshape(T, U)

    # --- unique packed key per slot, then the neighbor join in packed space
    uk = fs[fhead & freal][:C]
    unique_pk = SENT.expand(C).clone()
    unique_pk[: uk.shape[0]] = uk
    queries = torch.cat([(unique_pk[None] + pd_arr[:, None]).reshape(-1),
                         (unique_pk[None] - pd_arr[:, None]).reshape(-1)])
    neighbors = _neighbors(_join([unique_pk], [queries], "lex"), d, C)

    return PermutohedralPlan(
        slot=None, bary=bary_t.T, neighbors=neighbors, num_valid=num_valid,
        tile_A=tile_A, tile_vid=tile_vid, tile_overflow=tile_overflow)


def rotation_matrices(d: int, k: int, seed: int = 7) -> list[np.ndarray]:
    """k fixed orthogonal rotations of feature space (identity first), from
    the same numpy RNG calls as the JAX package."""
    rs = np.random.RandomState(seed)
    mats = [np.eye(d)]
    for _ in range(1, k):
        q, r = np.linalg.qr(rs.randn(d, d))
        mats.append(q * np.sign(np.diag(r)))
    return mats


def count_vertices(ref: torch.Tensor) -> int:
    """Number of occupied lattice vertices for `ref` (dedup only)."""
    n, d = ref.shape
    key_cols, _ = _simplex_embed_cols(ref)
    _, row_changed, _ = _sort_rows([kc.reshape(n * (d + 1)) for kc in key_cols])
    return 1 + int(row_changed.sum())


def suggest_capacity(ref: torch.Tensor, headroom: float = 2.0) -> int:
    """Capacity suggestion: pow2 ≥ headroom·occupancy (at least 64)."""
    want = max(int(count_vertices(ref) * headroom), 64)
    return 1 << (want - 1).bit_length()


def suggest_sort_mode(ref: torch.Tensor) -> str:
    """'packed1' when this guide's lattice ranges, widened by the ±(d+2)
    neighbor margin, pack into 30 bits with the lean build's sentinel and
    query headroom; 'auto' otherwise. The bound is the JAX package's, so
    both packages take the same plan path on the same guide."""
    d = ref.shape[1]
    key_cols, _ = _simplex_embed_cols(ref)
    marg = d + 2
    lim = torch.stack([torch.stack([c.min(), c.max()]) for c in key_cols]).tolist()
    rngs = [hi - lo + 1 + 2 * marg for lo, hi in lim]
    strides = [1] * d
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * rngs[k + 1]
    pk_max = strides[0] * rngs[0] - 1
    max_pd = max(abs(_packed_delta(dl, strides)) for dl in _neighbor_deltas(d))
    return "packed1" if pk_max + 2 * max_pd + 2 < 2 ** 30 else "auto"


def suggest_tile_u(ref: torch.Tensor, tile: int, max_vertices: int,
                   headroom: float = 1.33) -> int:
    """Per-tile vertex capacity: headroom·(most distinct vertices in any
    tile of `tile` consecutive pixels), rounded up to a multiple of 128 and
    capped at tile·(d+1). Builds one throwaway plan."""
    n, d = ref.shape
    slot = build_plan(ref, max_vertices=max_vertices).slot
    T = n // tile
    s, _ = torch.sort(slot[: T * tile].reshape(T, tile * (d + 1)), dim=1)
    umax = int((1 + (s[:, 1:] != s[:, :-1]).sum(1)).max())
    want = min(int(np.ceil(umax * headroom)), tile * (d + 1))
    return -(-want // 128) * 128


# ---------------------------------------------------------------------------
# Apply: splat → blur → slice (linear in src)
# ---------------------------------------------------------------------------


def _segment_sum(rows: torch.Tensor, seg: torch.Tensor, C: int, out_dtype) -> torch.Tensor:
    """Sum (M, L) rows into the (C+1, L) vertex table by slot id, in the
    rows' (f32) dtype; row C, the sentinel, ends zero."""
    vals = torch.zeros(C + 1, rows.shape[1], dtype=rows.dtype, device=rows.device)
    vals.index_add_(0, seg, rows)
    vals[C] = 0
    return vals.to(out_dtype)


def _splat(plan: PermutohedralPlan, src: torch.Tensor) -> torch.Tensor:
    """(n, L) → (C+1, L) vertex values; row C is the zero sentinel.

    The tiled form is one batched (U, P) @ (P, L) product per tile, with
    the source rounded to the blocks' dtype and the products kept in f32
    (a bf16 `bmm` would round each tile's partials). An untiled plan keeps
    its entries in slot order, and its splat is
    `ops/cuda/lattice.splat_untiled`: the kernel on the card, the plain
    version on the CPU."""
    if plan.tile_A is not None:
        L = src.shape[1]
        acc = torch.promote_types(src.dtype, torch.float32)
        T, P, U = plan.tile_A.shape
        s3 = src.reshape(T, P, L).to(plan.tile_A.dtype).to(acc)
        partials = torch.bmm(plan.tile_A.transpose(1, 2).to(acc), s3)
        return _segment_sum(partials.reshape(T * U, L), plan.tile_vid.reshape(-1),
                            plan.capacity, src.dtype)
    return _kernels.splat_untiled(plan, src)


def _blur_pass(vals: torch.Tensor, nbr: torch.Tensor, shift_rows: bool = False) -> torch.Tensor:
    """One axis of the unnormalized [1/2, 1, 1/2] lattice blur; with
    `shift_rows` each vertex's row is then shifted to a minimum of 0."""
    M = vals.shape[0] - 1
    if not shift_rows:
        new = vals[:M] + 0.5 * (vals[nbr[:, 0]] + vals[nbr[:, 1]])
        return torch.cat([new, vals[M:]])
    # written into the new table in place of a `cat`'s copy, which pays for
    # the shift's two passes; the same roundings as above (0.5·y is exact)
    out = torch.empty_like(vals)
    out[M:] = vals[M:]
    new = out[:M]
    torch.add(vals[:M], vals[nbr[:, 0]] + vals[nbr[:, 1]], alpha=0.5, out=new)
    new.sub_(new.amin(1, keepdim=True))
    return out


def _blur(plan: PermutohedralPlan, vals: torch.Tensor, reverse: bool,
          shift_rows: bool = False) -> torch.Tensor:
    """The d+1 passes; with `shift_rows` the first, third, ... shift the
    rows. A pass at most doubles a row of non-negative values, so between
    shifts they grow at most fourfold (a shift every pass, at twice the
    cost, left the stereo pipeline's maps as far from float64's)."""
    d = plan.d
    for k, j in enumerate(range(d, -1, -1) if reverse else range(d + 1)):
        vals = _blur_pass(vals, plan.neighbors[j], shift_rows and k % 2 == 0)
    return vals


def _slice(plan: PermutohedralPlan, vals: torch.Tensor) -> torch.Tensor:
    """Vertex values back to pixels with barycentric weights, scaled by
    1/(1+2^-d). Untiled, `ops/cuda/lattice.slice_untiled`: the kernel on
    the card, the plain version on the CPU."""
    if plan.tile_A is not None:
        T, P, U = plan.tile_A.shape
        acc = torch.promote_types(vals.dtype, torch.float32)
        V = vals[plan.tile_vid].to(plan.tile_A.dtype).to(acc)  # (T, U, L)
        out = torch.bmm(plan.tile_A.to(acc), V)
        return out.reshape(T * P, -1).to(vals.dtype) * _kernels.slice_scale(plan.d)
    return _kernels.slice_untiled(plan, vals)


def apply_plan(plan: PermutohedralPlan, src: torch.Tensor, reverse: bool = False,
               shift_rows: bool = False, shift_out: bool = False) -> torch.Tensor:
    """Filter (n, L) values through a prebuilt plan. Linear in `src`;
    `reverse=True` traverses the blur axes in reverse (the transpose).

    `shift_rows=True` is for a caller that needs the result only up to a
    constant a row, as a softmax's input: every second blur pass shifts
    each vertex's row to a minimum of 0 (`_blur`), which adds a constant
    to each output row (the slice sums the vertices' shifts with the
    pixel's weights) and keeps the table's values, and so what rounding
    them to a narrow dtype loses, small.

    `shift_out=True`, for such a caller that needs no gradient, returns
    each output row shifted to a minimum of 0 and rounded to bfloat16:
    untiled, the shifted slice (`ops/cuda/lattice.slice_untiled_shifted`,
    one kernel on the card, counted as `lattice.slice.shifted`); tiled,
    the slice followed by `shift_rows_bf16`. Both give the bits of the
    slice followed by `shift_rows_bf16`."""
    launched = _kernels.lattice_splat.launches, _kernels.lattice_slice.launches
    with span("lattice.splat"):
        vals = _splat(plan, src)
    with span("lattice.blur"):
        vals = _blur(plan, vals, reverse, shift_rows)
    with span("lattice.slice"):
        if not shift_out:
            out = _slice(plan, vals)
        elif plan.tile_A is None:
            out = _kernels.slice_untiled_shifted(plan, vals)
            count("lattice.slice.shifted", 1)
        else:
            out = _kernels.shift_rows_bf16(_slice(plan, vals))
    if plan.tile_A is None:
        count("lattice.apply.untiled", 1)
        if (_kernels.lattice_splat.launches > launched[0]
                and _kernels.lattice_slice.launches > launched[1]):
            count("lattice.apply.kernel", 1)
    return out


# ---------------------------------------------------------------------------
# Differentiable filter
# ---------------------------------------------------------------------------


class _PlannedFilter(torch.autograd.Function):
    """apply_plan(plan, src) with gradients for src and ref. The plan rides
    on ctx, so its tables are neither saved tensors nor differentiated;
    `bary`'s dependence on ref is accounted for by the 4-filter identity."""

    @staticmethod
    def forward(ctx, src, ref, plan):
        ctx.plan = plan
        ctx.save_for_backward(src, ref)
        return apply_plan(plan, src)

    @staticmethod
    @span("lattice.backward")
    def backward(ctx, g):
        src, ref = ctx.saved_tensors
        plan = ctx.plan
        grad_src = grad_ref = None
        if ctx.needs_input_grad[0]:
            # the forward is linear in src: the transposed filter, exactly
            grad_src = apply_plan(plan, g, reverse=True)
        if ctx.needs_input_grad[1]:
            # W_ij = exp(-‖r_i − r_j‖²/2):
            #   dL/dr_i = −[s_i r_i (Wg)_i − s_i (W(g⊗r))_i
            #              + g_i r_i (Ws)_i − g_i (W(s⊗r))_i]
            # as one filter call of width 2L(d+1) through the same plan
            n, L = src.shape
            d = ref.shape[1]
            gf = g[..., None] * ref[:, None, :]  # (n, L, d)
            sf = src[..., None] * ref[:, None, :]
            filtered = apply_plan(plan, torch.cat(
                [g, gf.reshape(n, L * d), src, sf.reshape(n, L * d)], dim=-1))
            wg = filtered[:, :L]
            wgf = filtered[:, L: L + L * d].reshape(n, L, d)
            ws = filtered[:, L + L * d: 2 * L + L * d]
            wsf = filtered[:, 2 * L + L * d:].reshape(n, L, d)
            grad_ref = -(sf * wg[..., None] - src[..., None] * wgf
                         + gf * ws[..., None] - g[..., None] * wsf).sum(-2)
        return grad_src, grad_ref, None


def lattice_filter_planned(src: torch.Tensor, ref: torch.Tensor,
                           plan: PermutohedralPlan) -> torch.Tensor:
    """Filter (n, L) values through a prebuilt plan, differentiable in src
    and ref. The caller guarantees `plan == build_plan(ref.detach())`."""
    return _PlannedFilter.apply(src, ref, plan)


def lattice_filter(src: torch.Tensor, ref: torch.Tensor, normalize: str = "none",
                   num_lattices: int = 1, max_vertices: int | None = None) -> torch.Tensor:
    """Approximate Gaussian filter Σ_j exp(-‖ref_i − ref_j‖²/2)·src_j of
    (n, L) values over (n, d) features (pre-scaled by 1/σ).

    normalize: 'none' (unnormalized) or 'homogeneous' (divided by the
      filtered ones channel; gradients flow through the quotient).
    num_lattices: average k lattices at the fixed rotations of
      `rotation_matrices` (k× plan and apply)."""
    if normalize not in ("none", "homogeneous"):
        raise ValueError(f"unknown normalize mode {normalize!r}")
    x = src
    if normalize == "homogeneous":
        x = torch.cat([src, torch.ones_like(src[:, :1])], dim=-1)
    acc = None
    for m, R in enumerate(rotation_matrices(ref.shape[1], num_lattices)):
        ref_m = ref if m == 0 else ref @ torch.as_tensor(R, dtype=ref.dtype, device=ref.device)
        plan = build_plan(ref_m.detach(), max_vertices=max_vertices)
        out_m = lattice_filter_planned(x, ref_m, plan)
        acc = out_m if acc is None else acc + out_m
    out = acc / num_lattices if num_lattices > 1 else acc
    if normalize == "homogeneous":
        return out[:, :-1] / out[:, -1:].clamp_min(1e-20)
    return out


def lattice_adjacency(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(W − I) @ src, the message-passing operator."""
    return lattice_filter(src, ref) - src


def lattice_filter_batched(srcs: torch.Tensor, refs: torch.Tensor,
                           normalize: str = "none") -> torch.Tensor:
    """(B, n, L), (B, n, d) → (B, n, L); each item builds its own plan."""
    return torch.stack([lattice_filter(s, r, normalize) for s, r in zip(srcs, refs)])


def batched_lattice_adjacency(src_imgs: torch.Tensor, guide_imgs: torch.Tensor) -> torch.Tensor:
    """(B, h, w, L) values, (B, h, w, d) guides → (W − I) @ src per image."""
    B, h, w, L = src_imgs.shape
    out = lattice_filter_batched(src_imgs.reshape(B, h * w, L),
                                 guide_imgs.reshape(B, h * w, guide_imgs.shape[-1]))
    return out.reshape(B, h, w, L) - src_imgs
