"""The PyTorch port's spectral clustering against the JAX package's on the
CPU: the lattice Laplacian, the port's matrix-free LOBPCG, the spectral
embedding (by eigenvalues and subspaces: the start blocks come from
different generators), k-means and the segmentation up to relabelling, and
`apps.segment`."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.apps import segment
from depth_estimation_torch.ops import spectral as TS
from depth_estimation_torch.ops.permutohedral import build_plan
from depth_estimation_tpu.ops import spectral as JS
from depth_estimation_tpu.ops.permutohedral import build_plan as j_build_plan


def _guide(h, w, seed=0):
    """(h·w, 5) features [rgb/0.3, ij/2] of a smooth random image."""
    rs = np.random.RandomState(seed)
    img = rs.rand(h // 4 + 1, w // 4 + 1, 3).repeat(4, 0).repeat(4, 1)[:h, :w]
    img = (img + 0.05 * rs.rand(h, w, 3)).astype(np.float32)
    ii, jj = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.concatenate([img / 0.3, ii[..., None] / 2.0, jj[..., None] / 2.0],
                          -1).reshape(h * w, -1)


def _same_up_to_relabelling(a, b):
    """Labels a and b partition the pixels identically."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_laplacian_matvec_matches_jax():
    ref = _guide(12, 14)
    U = np.random.RandomState(1).randn(ref.shape[0], 3).astype(np.float32)
    plan_t = build_plan(torch.from_numpy(ref))
    ones = np.ones((ref.shape[0], 1), np.float32)
    deg_t = TS._adjacency(plan_t, torch.from_numpy(ones))

    @jax.jit
    def jax_side(r, u):
        plan = j_build_plan(r)
        deg = JS._adjacency(plan, jnp.ones_like(u[:, :1]))
        return deg, {m: JS.laplacian_matvec(plan, deg, u, m) for m in ("sym", "none")}

    deg_j, want = jax_side(jnp.asarray(ref), jnp.asarray(U))
    np.testing.assert_allclose(deg_t.numpy(), np.asarray(deg_j), rtol=1e-5, atol=1e-5)
    for mode in ("sym", "none"):
        got = TS.laplacian_matvec(plan_t, deg_t, torch.from_numpy(U), mode).numpy()
        np.testing.assert_allclose(got, np.asarray(want[mode]), rtol=1e-5, atol=1e-5,
                                   err_msg=mode)
    # (D − W_sym)·1 = 0 with D from the same symmetrized adjacency
    zero = TS.laplacian_matvec(plan_t, deg_t, torch.from_numpy(ones), "none")
    assert float(zero.abs().max()) < 1e-5
    with pytest.raises(ValueError):
        TS.laplacian_matvec(plan_t, deg_t, torch.from_numpy(U), "rw")


def test_lobpcg_matches_eigh():
    """The port's LOBPCG on a dense SPD matrix: the 4 largest eigenvalues to
    1e-4 of numpy's, and their eigenvectors' span."""
    rs = np.random.RandomState(0)
    n, k = 60, 4
    M = rs.randn(n, n)
    A = (M @ M.T / n + np.diag(np.linspace(0, 5, n))).astype(np.float32)
    theta, U, iters = TS.lobpcg_standard(lambda X: torch.from_numpy(A) @ X,
                                         torch.from_numpy(rs.randn(n, k).astype(np.float32)),
                                         m=200)
    w, V = np.linalg.eigh(A.astype(np.float64))
    np.testing.assert_allclose(theta.numpy(), w[::-1][:k], rtol=1e-4)
    assert 0 < iters <= 200
    cos = np.linalg.svd(V[:, ::-1][:, :k].T @ U.numpy().astype(np.float64), compute_uv=False)
    assert cos.min() > 1 - 1e-4, cos
    with pytest.raises(ValueError, match="5·k < n"):
        TS.lobpcg_standard(lambda X: X, torch.zeros(10, 2))


@pytest.fixture(scope="module")
def jax_embedding():
    """The JAX package's `spectral_embedding(ref, 4)` of a 24×24 guide,
    computed as `ops/spectral.py:80-93` does (its start block from
    `PRNGKey(0)`, 100 iterations at most), with the iteration count that
    `spectral_embedding` drops: one JAX compile for the two tests below."""
    from jax.experimental.sparse.linalg import lobpcg_standard as j_lobpcg

    ref = _guide(24, 24, seed=2)
    n, kk = ref.shape[0], 6  # k = 4 plus the 2 guard vectors
    X0 = jax.random.normal(jax.random.PRNGKey(0), (n, kk), jnp.float32)

    def run(r, x0):
        plan = j_build_plan(r)
        degree = jnp.maximum(JS._adjacency(plan, jnp.ones((n, 1), r.dtype)), 1e-3)
        return j_lobpcg(lambda U: 2.0 * U - JS.laplacian_matvec(plan, degree, U, "sym"), x0,
                        m=100)

    theta, U, iters = jax.jit(run)(jnp.asarray(ref), X0)
    return ref, np.array(X0), np.asarray(theta), np.asarray(U, np.float64), int(iters)


def test_lobpcg_follows_the_jax_solver(jax_embedding):
    """From the JAX embedding's start block on the same lattice operator
    (2I − L of the 24×24 guide), the port's LOBPCG stops at the same
    iteration as `jax.experimental.sparse.linalg.lobpcg_standard`, with the
    same eigenvalues to 1e-4."""
    ref, X0, theta_j, _, iters_j = jax_embedding
    plan = build_plan(torch.from_numpy(ref))
    deg = torch.clamp_min(TS._adjacency(plan, torch.ones(ref.shape[0], 1)), 1e-3)
    theta_t, _, iters_t = TS.lobpcg_standard(
        lambda U: 2 * U - TS.laplacian_matvec(plan, deg, U), torch.from_numpy(X0))
    assert iters_t == iters_j < 100
    np.testing.assert_allclose(theta_t.numpy(), theta_j, atol=1e-4)


def _rayleigh(L, U):
    LU = L(U)
    theta = (U * LU).sum(0) / (U * U).sum(0)
    resid = np.linalg.norm(LU - U * theta[None, :], axis=0) / np.linalg.norm(U, axis=0)
    return theta, resid


def test_spectral_embedding_matches_jax(jax_embedding):
    """k = 4: the port's eigenpairs (from its own start block) pass the JAX
    package's Rayleigh-residual gates (tests/test_spectral.py:100-104),
    their eigenvalues are within 1e-3 of the JAX embedding's, and the span
    of all but the last eigenvector is the JAX one's to principal angles
    under 1e-2."""
    ref, _, _, U_j, _ = jax_embedding
    k = 4
    U_j = U_j[:, :k]
    U_t = TS.spectral_embedding(torch.from_numpy(ref), k).numpy().astype(np.float64)
    plan = build_plan(torch.from_numpy(ref).double())
    deg = torch.clamp_min(TS._adjacency(plan, torch.ones(ref.shape[0], 1, dtype=torch.float64)),
                          1e-3)

    def L(U):
        return TS.laplacian_matvec(plan, deg, torch.from_numpy(U), "sym").numpy()

    theta_t, resid_t = _rayleigh(L, U_t)
    theta_j, _ = _rayleigh(L, U_j)
    assert resid_t[:-1].max() < 5e-2 and resid_t[-1] < 0.15, resid_t
    np.testing.assert_allclose(theta_t, theta_j, atol=1e-3)
    Q_t, _ = np.linalg.qr(U_t[:, :-1])
    Q_j, _ = np.linalg.qr(U_j[:, :-1])
    angles = np.arccos(np.clip(np.linalg.svd(Q_t.T @ Q_j, compute_uv=False), -1, 1))
    assert angles.max() < 1e-2, angles
    np.testing.assert_allclose(U_t.T @ U_t, np.eye(k), atol=1e-3)


def test_kmeans_separated_clusters_match_jax():
    """The JAX package's k-means test (tests/test_spectral.py:32-39): two
    clusters, whatever the two starting points."""
    rs = np.random.RandomState(0)
    X = np.concatenate([rs.randn(40, 2) * 0.05, rs.randn(40, 2) * 0.05 + 5]).astype(np.float32)
    got = TS.kmeans(torch.from_numpy(X), 2, niters=10)
    want = np.asarray(JS.kmeans(jnp.asarray(X), 2, niters=10))
    assert got.dtype == torch.int32 and got.shape == (80,)
    assert _same_up_to_relabelling(got.numpy(), want)
    assert len(np.unique(got[:40])) == len(np.unique(got[40:])) == 1 and got[0] != got[40]


def _two_regions(h=24, w=32):
    rs = np.random.RandomState(0)
    img = np.zeros((h, w, 3))
    img[:, : w // 2] = [0.9, 0.1, 0.1]
    img[:, w // 2:] = [0.1, 0.1, 0.9]
    return (img + rs.randn(h, w, 3) * 0.02).astype(np.float32)


def test_spectral_segment_two_regions_match_jax():
    img = _two_regions()
    kw = dict(num_segments=2, num_eigs=2, sigma_color=0.3, sigma_pos=10.0)
    got = TS.spectral_segment(img, device="cpu", **kw)
    want = np.asarray(JS.spectral_segment(jnp.asarray(img), **kw))
    assert got.shape == (24, 32) and got.dtype == torch.int32
    assert _same_up_to_relabelling(got.numpy(), want)
    assert got[0, 0] != got[0, -1]


def test_segment_app_on_cpu(tmp_path, capsys):
    from PIL import Image

    Image.fromarray((_two_regions() * 255).clip(0, 255).astype(np.uint8)).save(tmp_path / "i.png")
    args = ["--image", str(tmp_path / "i.png"), "--out", str(tmp_path / "labels.png"),
            "--segments", "2", "--eigs", "2", "--sigma-color", "0.3", "--sigma-pos", "10"]
    assert segment.main(args + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"shape": [24, 32], "segments_found": 2, "out": str(tmp_path / "labels.png")}
    assert np.asarray(Image.open(tmp_path / "labels.png")).shape == (24, 32, 3)
