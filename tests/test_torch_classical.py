"""The PyTorch port's classical refiners, LSH filter and mask depth against
the JAX package's on the CPU, on the same seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.models import maskdepth as TM
from depth_estimation_torch.ops import classical as TC
from depth_estimation_torch.ops import lsh as TL
from depth_estimation_torch.ops.dense_gaussian import dense_gaussian_filter
from depth_estimation_tpu.models import maskdepth as JM
from depth_estimation_tpu.ops import classical as JC
from depth_estimation_tpu.ops import lsh as JL

SMOOTH_TOL = dict(rtol=1e-5, atol=1e-5)
CG_TOL = dict(rtol=1e-4, atol=1e-4)


def _scene(dtype=np.float32, h=40, w=56, noise=0.5):
    """The JAX package's two-plane scene (tests/test_classical.py:16-29)."""
    rs = np.random.RandomState(0)
    img = np.zeros((h, w, 3))
    img[:, : w // 2] = [0.8, 0.2, 0.2]
    img[:, w // 2:] = [0.2, 0.2, 0.8]
    img += rs.randn(h, w, 3) * 0.01
    disp = np.zeros((h, w))
    disp[:, : w // 2] = 4.0
    disp[:, w // 2:] = 9.0
    return img.astype(dtype), (disp + rs.randn(h, w) * noise).astype(dtype)


def _both(x):
    return torch.from_numpy(x), jnp.asarray(x)


def test_joint_bilateral_smooth_matches_jax():
    """In float64, as every lattice comparison here: in float32 the JAX
    package's lattice filter rounds further from its float64 result than
    1e-5 on this scene, while the port's stays well inside it."""
    (img_t, img_j), (d_t, d_j) = map(_both, _scene(np.float64))
    got = TC.joint_bilateral_smooth(d_t, img_t)
    want = jax.jit(JC.joint_bilateral_smooth)(d_j, img_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SMOOTH_TOL)


def test_iterated_guided_smooth_matches_jax():
    """In float64: in float32 the guided filter's cumsum boxes and
    E[xx] − E[x]² round apart by ~2e-4 of its scale in the two packages
    (tests/test_torch_refiner.py)."""
    (img_t, img_j), (d_t, d_j) = map(_both, _scene(np.float64))
    got = TC.iterated_guided_smooth(d_t, img_t)
    want = jax.jit(JC.iterated_guided_smooth)(d_j, img_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SMOOTH_TOL)


def test_laplacian_apply_matches_jax():
    x = np.random.RandomState(3).randn(10, 12).astype(np.float32)
    np.testing.assert_allclose(TC.laplacian_apply(torch.from_numpy(x)).numpy(),
                               np.asarray(JC.laplacian_apply(jnp.asarray(x))), **SMOOTH_TOL)
    assert float(TC.laplacian_apply(torch.full((5, 7), 3.0)).abs().max()) == 0.0


def test_cg_refine_laplacian_matches_jax():
    _, (d_t, d_j) = map(_both, _scene())
    got = TC.cg_refine_laplacian(d_t, lam=2.0, maxiter=50)
    want = JC.cg_refine_laplacian(d_j, lam=2.0, maxiter=50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CG_TOL)


def test_cg_refine_bilateral_matches_jax():
    (img_t, img_j), (d_t, d_j) = map(_both, _scene(np.float64))
    got = TC.cg_refine_bilateral(d_t, img_t, lam=8.0, maxiter=30)
    want = jax.jit(lambda d, i: JC.cg_refine_bilateral(d, i, lam=8.0, maxiter=30))(d_j, img_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CG_TOL)


def test_cg_stops_at_the_tolerance_and_never_past_maxiter():
    """A diagonal system converges in one step per distinct eigenvalue; the
    matvec count shows where the loop stopped."""
    b = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    calls = []

    def A(x):
        calls.append(1)
        return 2.0 * x

    x = TC.cg(A, b, torch.zeros_like(b), maxiter=100)
    torch.testing.assert_close(x, b / 2)
    assert len(calls) == 2  # the initial residual and one step
    calls.clear()
    TC.cg(lambda x: calls.append(1) or torch.arange(1.0, 5.0, dtype=torch.float64) * x, b,
          torch.zeros_like(b), maxiter=2)
    assert len(calls) == 3


def _lsh_inputs(n=200, d=3, L=4):
    rs = np.random.RandomState(0)
    centers = rs.randn(6, d) * 20
    pts = np.concatenate([c + rs.randn(n // 6 + 1, d) * 0.3 for c in centers])[:n]
    return pts.astype(np.float32), rs.rand(n, L).astype(np.float32)


def test_lsh_assembly_matches_jax_given_its_buckets():
    """Fed the JAX package's bucket ids, the port's candidate assembly and
    weighting give the JAX filter's output."""
    pts, src = _lsh_inputs()
    kw = dict(bucket_width=4.0, num_tables=6, window=64)
    buckets = JL._bucket_ids(jnp.asarray(pts), jax.random.PRNGKey(0), kw["bucket_width"],
                             kw["num_tables"])
    got = TL.lsh_filter_from_buckets(torch.from_numpy(src), torch.from_numpy(pts),
                                     torch.from_numpy(np.array(buckets)), kw["window"])
    want = JL.lsh_gaussian_filter(jnp.asarray(src), jnp.asarray(pts), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_lsh_filter_matches_dense_on_clusters():
    """The JAX package's bound (tests/test_lsh.py:10-23): clustered points,
    mean relative error under 0.05 against the dense filter."""
    pts, src = _lsh_inputs(n=180)
    got = TL.lsh_gaussian_filter(torch.from_numpy(src), torch.from_numpy(pts), bucket_width=4.0,
                                 num_tables=6, window=64)
    dense = dense_gaussian_filter(torch.from_numpy(src), torch.from_numpy(pts), block=64)
    rel = (got - dense).abs() / (dense.abs() + 1e-9)
    assert float(rel.mean()) < 0.05, float(rel.mean())
    buckets = TL.bucket_ids(torch.from_numpy(pts), 4.0, 6)
    assert buckets.shape == (6, 180) and buckets.dtype == torch.int32
    assert torch.equal(buckets, TL.bucket_ids(torch.from_numpy(pts), 4.0, 6))


def test_lsh_self_term_exact():
    rs = np.random.RandomState(1)
    pts = torch.from_numpy(rs.randn(50, 4) * 100)  # far apart: only self terms survive
    src = torch.from_numpy(rs.rand(50, 3))
    torch.testing.assert_close(TL.lsh_gaussian_filter(src, pts, num_tables=2, window=8), src)


def test_phase_correlation_offsets_match_jax():
    rs = np.random.RandomState(0)
    img = rs.rand(64, 96, 3).astype(np.float32)
    for s in (0, 3, 7, 20):
        shifted = np.roll(img, -s, axis=1)
        got = TM.phase_correlation_offset(torch.from_numpy(img), torch.from_numpy(shifted))
        want = JM.phase_correlation_offset(jnp.asarray(img), jnp.asarray(shifted))
        assert int(got) == int(want) == s


def test_composite_mask_depth_matches_jax():
    rs = np.random.RandomState(0)
    h, w = 48, 64
    left = rs.rand(h, w, 3).astype(np.float32)
    right = np.roll(left, -4, axis=1)
    masks = np.zeros((3, h, w), np.float32)
    masks[0, 10:30, 10:30] = 1
    masks[1, 20:40, 30:50] = 1
    masks[2, 5:15, 40:60] = 1
    right[5:15, 40:60] = np.roll(left, -9, axis=1)[5:15, 40:60]
    got = TM.composite_mask_depth(torch.from_numpy(left), torch.from_numpy(right),
                                  torch.from_numpy(masks))
    want = JM.composite_mask_depth(jnp.asarray(left), jnp.asarray(right), jnp.asarray(masks))
    assert got.shape == (h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0] == 0 and got[25, 35] == got[35, 45]  # the later mask wins the overlap
