"""Parity of the PyTorch port's permutohedral lattice with the JAX package
on the CPU: plans built from the same float32 guides agree on `num_valid`
and `tile_overflow`, and `apply_plan` agrees on the filtered values (vertex
order inside a plan may differ; the filter does not depend on it)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.ops import dense_gaussian as Td
from depth_estimation_torch.ops.cuda.lattice import CHUNK
from depth_estimation_torch.ops import permutohedral as T
from depth_estimation_tpu.ops import permutohedral as J

# (kind, tile_bf16): the general entry-wise plan, the general plan with
# tiled tables, and the lean per-tile plan (sort_mode='packed1')
PATHS = [("general", False), ("tiled", False), ("tiled", True),
         ("lean", False), ("lean", True)]


def _guide(seed, n=1024, d=5, scale=1.5):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d) * scale).astype(np.float32), rs.rand(n, 4).astype(np.float32)


def _plan_kwargs(kind, tile_bf16, max_vertices=4096, tile_u=384):
    kw = dict(max_vertices=max_vertices)
    if kind in ("tiled", "lean"):
        kw.update(tile=64, tile_u=tile_u, tile_bf16=tile_bf16)
    if kind == "lean":
        kw.update(sort_mode="packed1", order_by_sum=False)
    return kw


def _both(ref, src, kw, reverse=False):
    pj = jax.jit(partial(J.build_plan, **kw))(jnp.asarray(ref))
    oj = np.asarray(jax.jit(partial(J.apply_plan, reverse=reverse))(pj, jnp.asarray(src)))
    pt = T.build_plan(torch.from_numpy(ref), **kw)
    ot = T.apply_plan(pt, torch.from_numpy(src), reverse=reverse).numpy()
    return pj, oj, pt, ot


def _assert_close(ot, oj, tile_bf16):
    scale = np.abs(oj).max()
    if not tile_bf16:
        np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5 * scale)
        return
    # bf16 incidence blocks: the slice rounds the vertex values to bf16, so
    # f32-level differences in the splat sums (the JAX package takes them
    # as differences of a running prefix sum, the port by index_add_) flip
    # single roundings. Bound: one bf16 ulp (2^-8) of the output's max;
    # almost every value still agrees to f32 rounding.
    np.testing.assert_allclose(ot, oj, rtol=0, atol=2.0 ** -8 * scale)
    assert np.mean(np.abs(ot - oj) <= 1e-5 * scale) > 0.95


@pytest.mark.parametrize("kind,tile_bf16", PATHS)
@pytest.mark.parametrize("reverse", [False, True])
def test_apply_plan_matches_jax(kind, tile_bf16, reverse):
    ref, src = _guide(0)
    pj, oj, pt, ot = _both(ref, src, _plan_kwargs(kind, tile_bf16), reverse)
    assert (pt.slot is None) == (kind == "lean")
    assert int(pt.num_valid) == int(pj.num_valid)
    if kind != "general":
        assert int(pt.tile_overflow) == int(pj.tile_overflow) == 0
    _assert_close(ot, oj, tile_bf16)


@pytest.mark.parametrize("kind,max_vertices", [("general", 256), ("tiled", 4096),
                                               ("lean", 256)])
def test_capacity_overflow_matches_jax(kind, max_vertices):
    """Vertex capacity below occupancy, and tiles over tile_u: the same
    vertices and entries soft-drop in both packages."""
    ref, src = _guide(1, n=512, d=4)
    pj, oj, pt, ot = _both(ref, src, _plan_kwargs(kind, False, max_vertices, tile_u=64))
    assert int(pt.num_valid) == int(pj.num_valid)
    if kind != "tiled":
        assert int(pj.num_valid) > max_vertices
    if kind != "general":
        assert int(pt.tile_overflow) == int(pj.tile_overflow) > 0
    _assert_close(ot, oj, False)


@pytest.mark.parametrize("mode", ["lex", "packed1", "packed2", "auto"])
def test_sort_rows_matches_numpy_lexsort(mode):
    rs = np.random.RandomState(2)
    cols = [rs.randint(-5, 6, size=400) for _ in range(4)]
    payload = rs.rand(400)
    order, row_changed, (pay,) = T._sort_rows(
        [torch.from_numpy(c) for c in cols], (torch.from_numpy(payload),), mode)
    want = np.lexsort(cols[::-1])  # stable; first column most significant
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(pay.numpy(), payload[want])
    rows = np.stack(cols, 1)[want]
    np.testing.assert_array_equal(row_changed.numpy(), (rows[1:] != rows[:-1]).any(1))


def test_simplex_embed_matches_jax():
    ref, _ = _guide(3, n=500)
    kj, bj = jax.jit(J.simplex_embed)(jnp.asarray(ref))
    kt, bt = T.simplex_embed(torch.from_numpy(ref))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-6)


def test_calibration_helpers_match_jax():
    ref, _ = _guide(4, n=2048, scale=1.0)
    rj, rt = jnp.asarray(ref), torch.from_numpy(ref)
    assert T.count_vertices(rt) == int(J.count_vertices(rj))
    cap = T.suggest_capacity(rt, headroom=3.0)
    assert cap == J.suggest_capacity(rj, headroom=3.0)
    assert T.suggest_sort_mode(rt) == J.suggest_sort_mode(rj)
    assert T.suggest_sort_mode(rt * 40) == J.suggest_sort_mode(rj * 40) == "auto"
    assert T.suggest_tile_u(rt, 256, cap) == J.suggest_tile_u(rj, 256, cap)
    for k in (1, 3):
        for a, b in zip(T.rotation_matrices(5, k), J.rotation_matrices(5, k)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["general", "tiled", "lean"])
def test_lattice_agrees_with_dense_oracle(kind):
    """As tests/test_permutohedral.py holds the JAX lattice: d=3 features,
    correlation with the exact dense filter and the homogeneous-normalized
    relative error."""
    rs = np.random.RandomState(5)
    ref = torch.from_numpy((rs.randn(320, 3) * 1.5).astype(np.float32))
    src = torch.from_numpy(rs.rand(320, 2).astype(np.float32))
    kw = dict(max_vertices=None)
    if kind != "general":
        kw.update(tile=64, tile_u=256)
    if kind == "lean":
        kw.update(sort_mode="packed1", order_by_sum=False)
    plan = T.build_plan(ref, **kw)
    both = T.apply_plan(plan, torch.cat([src, torch.ones(320, 1)], 1)).numpy()
    out_l, deg_l = both[:, :2], both[:, 2:]
    out_d = Td.dense_gaussian_filter(src, ref, block=64).numpy()
    deg = Td.dense_gaussian_filter(torch.ones(320, 1), ref, block=64).numpy()
    assert np.corrcoef(out_l.ravel(), out_d.ravel())[0, 1] > 0.998
    rel = np.abs(out_l / deg_l - out_d / deg) / (np.abs(out_d / deg) + 1e-9)
    assert rel.mean() < 0.02


def test_pinned_packed_mode_that_does_not_fit_raises():
    cols = [torch.tensor([0, 1 << 40]), torch.tensor([0, 1 << 40]), torch.tensor([0, 1])]
    with pytest.raises(ValueError):
        T._sort_rows(cols, mode="packed1")
    order, _, _ = T._sort_rows(cols, mode="auto")  # falls back to an exact order
    np.testing.assert_array_equal(order.numpy(), [0, 1])


@pytest.mark.parametrize("n,d,L,pack,max_vertices,max_pieces", [
    (777, 4, 16, 8, None, None), (640, 5, 8, 16, None, None), (500, 3, 4, 8, None, None),
    (512, 4, 16, 8, 256, 8192),  # vertex overflow
])
@pytest.mark.parametrize("reverse", [False, True])
def test_port_plan_matches_jax_piece_plan(n, d, L, pack, max_vertices, max_pieces, reverse):
    """The JAX package's piece splat (a plan built with `max_pieces` at
    `pack` pixels a group, the capacity `suggest_pieces` gives unless
    pinned) computes the entry splat's sums: the port's untiled plan,
    which has no pieces, filters as the JAX package's pieced one does, in
    both blur orders and where vertices overflow the capacity."""
    rs = np.random.RandomState(n)
    ref = (rs.randn(n, d) * 1.5).astype(np.float32)
    src = rs.rand(n, L).astype(np.float32)
    cap = max_vertices or T.suggest_capacity(torch.from_numpy(ref))
    pieces = max_pieces or J.suggest_pieces(jnp.asarray(ref), cap, pack=pack)
    pj = jax.jit(partial(J.build_plan, max_vertices=cap, max_pieces=pieces, pack=pack))(
        jnp.asarray(ref))
    assert pj.piece_weights is not None and int(pj.num_pieces) <= pieces
    oj = np.asarray(jax.jit(partial(J.apply_plan, reverse=reverse))(pj, jnp.asarray(src)))
    pt = T.build_plan(torch.from_numpy(ref), max_vertices=cap)
    assert pt.entry_order is not None
    assert int(pt.num_valid) == int(pj.num_valid)
    assert (int(pt.num_valid) > cap) == (max_vertices is not None)
    ot = T.apply_plan(pt, torch.from_numpy(src), reverse=reverse).numpy()
    _assert_close(ot, oj, False)


@pytest.mark.parametrize("kind", ["general", "tiled"])
def test_shift_rows_adds_a_constant_a_row_and_keeps_bf16_values_small(kind):
    """`apply_plan(..., shift_rows=True)` shifts each vertex's row to a
    minimum of 0 after every second blur pass. In float64 its output
    differs from the plain filter's by a constant a row (to the f32 blocks'
    rounding on the tiled path); on rows that share a large offset its
    values stay near 0, so a bf16 table loses far less of them: under half
    the plain bf16 filter's error, a row's constant aside (measured 19
    against 61 untiled, 18 against 103 tiled)."""
    ref, _ = _guide(3)
    rs = np.random.RandomState(4)
    src = torch.from_numpy(rs.rand(ref.shape[0], 24) * 10 + rs.rand(ref.shape[0], 1) * 1000)
    plan = T.build_plan(torch.from_numpy(ref), **_plan_kwargs(kind, False))
    plain = T.apply_plan(plan, src)
    shifted = T.apply_plan(plan, src, shift_rows=True)
    scale = plain.abs().max()
    gap = plain - shifted
    assert (gap - gap[:, :1]).abs().max() <= 1e-6 * scale
    assert shifted.amin(1).min() >= -1e-9 * scale and shifted.amin(1).max() <= 1e-3 * scale

    def off(x, exact):  # the largest error, less the row's mean error
        e = x.double() - exact
        return (e - e.mean(1, keepdim=True)).abs().max()

    low = src.to(torch.bfloat16)
    assert off(T.apply_plan(plan, low, shift_rows=True), shifted) < 0.5 * off(
        T.apply_plan(plan, low), plain)


@pytest.mark.parametrize("n,d,kw", [
    (1024, 5, dict(max_vertices=4096)),
    (512, 4, dict(max_vertices=256)),  # capacity overflow
    (300, 3, dict(max_vertices=None)),
    (512, 5, dict(max_vertices=4096, sort_mode="lex", order_by_sum=True)),
    # every untiled plan carries the table: at the calibrated capacity
    (777, 4, dict()), (640, 5, dict()), (500, 3, dict()),
])
def test_entry_table_describes_the_slots(n, d, kw):
    """`entry_order` lists the entries (e = r·n + i) slot by slot, each
    slot's in increasing order, `entry_weight` their weights, and
    `slot_start` where each slot's begin: exactly what `slot` says, the
    overflow entries (slot C, in the order of the vertices they lost) past
    slot_start[C]; slots past the occupied ones start at N. `chunk_start`
    numbers the splat kernel's chunks, slot by slot."""
    ref, _ = _guide(7 + d, n=n, d=d)
    kw = kw or dict(max_vertices=T.suggest_capacity(torch.from_numpy(ref)))
    plan = T.build_plan(torch.from_numpy(ref), **kw)
    C, N = plan.capacity, n * (d + 1)
    assert plan.entry_order.dtype == plan.slot_start.dtype == torch.int32
    assert plan.entry_order.shape == (N,) and plan.slot_start.shape == (C + 1,)
    slot_e = plan.slot.T.reshape(N).numpy()  # the slot of entry e = r·n + i
    want = np.argsort(slot_e, kind="stable")
    got = plan.entry_order.numpy()
    kept = int(plan.slot_start[C])
    np.testing.assert_array_equal(got[:kept], want[:kept])
    np.testing.assert_array_equal(np.sort(got[kept:]), want[kept:])
    assert plan.entry_weight.dtype == plan.bary.dtype
    np.testing.assert_array_equal(plan.entry_weight.numpy(),
                                  plan.bary.T.reshape(N).numpy()[got])
    np.testing.assert_array_equal(plan.slot_start.numpy(),
                                  np.searchsorted(slot_e[want], np.arange(C + 1)))
    # the splat's chunks, slot by slot: ceil(entries / CHUNK) each
    chunks = -(-np.diff(plan.slot_start.numpy()) // CHUNK)
    assert plan.chunk_start.dtype == torch.int32
    np.testing.assert_array_equal(plan.chunk_start.numpy(), np.r_[0, np.cumsum(chunks)])
    overflow = int(plan.num_valid) > C
    assert overflow == (kw["max_vertices"] == 256)
    assert (int(plan.slot_start[C]) < N) == overflow


@pytest.mark.parametrize("kind", ["tiled", "lean"])
def test_tiled_lean_and_piece_plans_carry_no_entry_table(kind):
    ref, _ = _guide(8, n=256)
    plan = T.build_plan(torch.from_numpy(ref), **_plan_kwargs(kind, False))
    assert (plan.entry_order, plan.entry_weight, plan.slot_start, plan.chunk_start) == (None,) * 4


@pytest.mark.parametrize("L,vec,team,passes", [
    (1, 1, 1, 1), (2, 1, 2, 1), (16, 8, 2, 1), (128, 8, 16, 1), (129, 1, 32, 5),
    (320, 8, 32, 2), (1536, 8, 32, 6)])
def test_apply_geometry_covers_each_row(L, vec, team, passes):
    """The lattice kernels' teams: the fewest lanes (a power of two up to
    32) that cover L at `vec` values a lane (16-byte words where L allows),
    the rest in column passes."""
    from depth_estimation_torch.ops.cuda import lattice as K

    g = K.apply_geometry(1000, L, K.VEC if L % K.VEC == 0 else 1)
    assert (g.vec, g.team, g.passes) == (vec, team, passes)
    assert g.grid == -(-1000 * team // K.THREADS)
    assert (g.passes - 1) * g.team * g.vec < L <= g.passes * g.team * g.vec
    with pytest.raises(ValueError):
        K.lattice_slice(torch.zeros(5, L), torch.zeros(3, 6, dtype=torch.int64),
                        torch.zeros(3, 6), 1.0)  # a CPU tensor: the kernel runs on the card
