"""Parity of the PyTorch port's piece-splat tables with the JAX package on
the CPU: the filter through piece tables equals the JAX package's filter
with pieces, and its splat the port's entry-wise splat (f32, 1e-5 of the
largest value); the same pieces are counted and, when the piece capacity
binds, the same mass drops. Only outputs are held to the JAX package, not
table layouts."""
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models import pipeline as TP
from depth_estimation_torch.ops import permutohedral as T
from depth_estimation_tpu.models import pipeline as JP
from depth_estimation_tpu.ops import permutohedral as J

RTOL = 1e-5  # of the largest |value|: f32 sums taken in another order


def _guide(seed, n, d, L):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d) * 1.5).astype(np.float32), rs.rand(n, L).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * np.abs(b).max())


@pytest.mark.parametrize("n,d,L,pack", [(777, 4, 16, 8), (640, 5, 8, 16), (500, 3, 4, 8)])
def test_piece_splat_matches_jax_and_entry_splat(n, d, L, pack):
    ref, src = _guide(0, n, d, L)
    cap = T.suggest_capacity(torch.from_numpy(ref))
    pieces = T.suggest_pieces(torch.from_numpy(ref), cap, pack=pack)
    assert pieces == J.suggest_pieces(jnp.asarray(ref), cap, pack=pack)
    kw = dict(max_vertices=cap, max_pieces=pieces, pack=pack)
    pj = jax.jit(partial(J.build_plan, **kw))(jnp.asarray(ref))
    pt = T.build_plan(torch.from_numpy(ref), **kw)
    plain = T.build_plan(torch.from_numpy(ref), max_vertices=cap)
    assert int(pt.num_pieces) == int(pj.num_pieces) <= pieces
    st = torch.from_numpy(src)
    _close(T._splat(pt, st).numpy(), T._splat(plain, st).numpy())
    out = T.apply_plan(pt, st).numpy()
    _close(out, np.asarray(jax.jit(J.apply_plan)(pj, jnp.asarray(src))))
    _close(out, T.apply_plan(plain, st).numpy())


def test_piece_overflow_drops_mass_as_jax():
    """Pieces beyond the capacity drop their mass (num_pieces > capacity
    shows it), the same pieces as in the JAX package."""
    ref, src = _guide(1, 400, 3, 16)
    kw = dict(max_vertices=2048, max_pieces=64, pack=8)
    pj = jax.jit(partial(J.build_plan, **kw))(jnp.asarray(ref))
    pt = T.build_plan(torch.from_numpy(ref), **kw)
    assert int(pt.num_pieces) == int(pj.num_pieces) > 64
    got = T._splat(pt, torch.from_numpy(src)).numpy()
    full = T._splat(T.build_plan(torch.from_numpy(ref), max_vertices=2048),
                    torch.from_numpy(src)).numpy()
    assert np.isfinite(got).all() and got.sum() < full.sum()
    # the JAX splat takes differences of a running prefix sum: its error
    # scales with the total, so the vertex tables compare at that scale
    want = np.asarray(jax.jit(J._splat)(pj, jnp.asarray(src)))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * src.sum())
    _close(T.apply_plan(pt, torch.from_numpy(src)).numpy(),
           np.asarray(jax.jit(J.apply_plan)(pj, jnp.asarray(src))))


def test_vertex_overflow_with_pieces_matches_jax():
    """Vertices beyond max_vertices (slot C) leave the piece splat as they
    leave the entry-wise one."""
    ref, src = _guide(2, 512, 4, 16)
    kw = dict(max_vertices=256, max_pieces=8192, pack=8)
    pj = jax.jit(partial(J.build_plan, **kw))(jnp.asarray(ref))
    pt = T.build_plan(torch.from_numpy(ref), **kw)
    assert int(pt.num_valid) == int(pj.num_valid) > 256
    st = torch.from_numpy(src)
    got = T.apply_plan(pt, st).numpy()
    _close(got, np.asarray(jax.jit(J.apply_plan)(pj, jnp.asarray(src))))
    _close(got, T.apply_plan(T.build_plan(torch.from_numpy(ref), max_vertices=256), st).numpy())


def test_wide_rows_and_tiled_plans_skip_the_piece_splat():
    """G·L > 128, or a tiled plan, splats without the piece tables; a
    pinned 'packed1' with pieces builds the general plan, as in JAX."""
    ref, src = _guide(3, 512, 4, 32)
    rt, st = torch.from_numpy(ref), torch.from_numpy(src)
    pt = T.build_plan(rt, max_vertices=4096, max_pieces=4096, pack=8)
    assert pt.piece_weights is not None
    _close(T._splat(pt, st).numpy(), T._splat(T.build_plan(rt, max_vertices=4096), st).numpy())
    tiled = T.build_plan(rt, max_vertices=4096, max_pieces=4096, pack=8, tile=64,
                         tile_u=384, sort_mode="packed1", order_by_sum=False)
    assert tiled.slot is not None and tiled.tile_A is not None
    pj = jax.jit(partial(J.build_plan, max_vertices=4096, max_pieces=4096, pack=8, tile=64,
                         tile_u=384, sort_mode="packed1", order_by_sum=False))(jnp.asarray(ref))
    _close(T.apply_plan(tiled, st[:, :16]).numpy(),
           np.asarray(jax.jit(J.apply_plan)(pj, jnp.asarray(src[:, :16]))))


def test_calibrate_with_pieces_matches_jax():
    left, right, _ = make_stereo_pair(np.random.RandomState(4), 32, 48, max_disp=5)
    left, right = left.astype(np.float32), right.astype(np.float32)
    kw = dict(num_disp=8, niters=2)
    cj = JP.calibrate_capacity(jnp.asarray(left), JP.CRFStereoConfig(**kw), pieces=True)
    ct = TP.calibrate_capacity(left, TP.CRFStereoConfig(**kw), pieces=True, device="cpu")
    assert ct.max_pieces == cj.max_pieces and ct.max_vertices == cj.max_vertices
    dj = np.asarray(JP.crf_stereo_infer(jnp.asarray(left), jnp.asarray(right), cj)["disparity"])
    out = TP.crf_stereo_infer(left, right, ct, device="cpu")
    assert out["plans"][0].piece_weights is not None
    dt = out["disparity"].numpy()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=5e-3)  # px, as the pipeline tests
    d_plain = TP.crf_stereo_infer(left, right, replace(ct, max_pieces=None), device="cpu")
    np.testing.assert_allclose(dt, d_plain["disparity"].numpy(), rtol=0, atol=1e-4)
