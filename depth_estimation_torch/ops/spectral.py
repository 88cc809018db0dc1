"""Spectral clustering by the lattice RBF graph Laplacian (counterpart of
the JAX package's `ops/spectral.py`).

The normalized bilateral affinity Laplacian over [rgb/σc, ij/σp] features,
its smallest eigenpairs by a matrix-free block eigensolver, and k-means of
the spectral embedding into segments. The matvec is the permutohedral
filter through one prebuilt plan; the eigensolver is LOBPCG on 2I − L, so
that the smallest eigenvectors of the PSD Laplacian become the largest.

`torch.lobpcg` takes only a dense or sparse matrix, and the Laplacian of a
288×384 image would be 110592² values, so `lobpcg_standard` is the port's
own: the JAX package's solver (`jax.experimental.sparse.linalg.
lobpcg_standard`, the robust LOBPCG of Duersch et al. 2018: orthonormal
X, P, R blocks kept by SVQB, "twice is enough" projections, P from the
Rayleigh-Ritz rotation, convergence by the residual against the float
error expected of it), step for step in PyTorch. Its loop tests
convergence on the host after each iteration.

Operators:
  sym   : L = I − D^{-1/2} (W−I) D^{-1/2}
  none  : L = D − W (unnormalized)
"""
from __future__ import annotations

from typing import Callable

import torch

from ..crf.guides import stack_guide
from ..models.pipeline import _as_image
from ..utils.device import resolve_device
from .permutohedral import PermutohedralPlan, apply_plan, build_plan

__all__ = [
    "lobpcg_standard",
    "laplacian_matvec",
    "spectral_embedding",
    "kmeans",
    "spectral_segment",
]


# ---------------------------------------------------------------------------
# LOBPCG (the JAX package's solver, matrix-free)
# ---------------------------------------------------------------------------


def _col_norms(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(X, dim=0, keepdim=True)


def _eigh_descending(A: torch.Tensor):
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis of X's columns from the eigenbasis of XᵀX;
    directions under eps·(largest eigenvalue) become zero columns."""
    norms = _col_norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    sqrted = torch.where(tau > 0, torch.maximum(w, tau), 1.0) ** -0.5
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep
    norms = _col_norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    return _svqb(_svqb(basis))  # twice is enough


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """U's component orthogonal to the orthonormal (zero columns allowed)
    `basis`; nonzero columns orthonormal, suspicious ones zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):  # end on a subtraction, so [basis, U] stays orthogonal
        U = U - basis @ (basis.T @ U)
    return U * (_col_norms(U) >= 0.99)


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """m columns orthonormal to the orthonormal (n, k) X, by a block
    Householder reflector (deterministic)."""
    n, k = X.shape
    upper, lower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower])
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros(n - k - m, m, dtype=X.dtype, device=X.device)])
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor], X: torch.Tensor, m: int = 100,
                    tol: float | None = None):
    """The top-k eigenpairs of the symmetric operator `A` (a callable on
    (n, j) blocks) from the (n, k) start `X` (0 < 5k < n), in at most `m`
    iterations. An eigenpair is converged when ‖Av − θv‖ < tol·10·n·(θ +
    ‖Av‖) (tol defaults to the dtype's eps); the loop stops early when all
    k are. Returns θ (k,) in descending order, U (n, k) and the iteration
    count."""
    n, k = X.shape
    if k == 0 or 5 * k >= n:
        raise ValueError(f"need 0 < 5·k < n, got k={k}, n={n}")
    if tol is None:
        tol = torch.finfo(X.dtype).eps
    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = (X * AX).sum(0, keepdim=True)
    R = AX - theta * X
    i, converged = 0, 0
    while i < m and converged < k:
        R = _project_out(torch.cat([X, P], 1), R)
        XPR = torch.cat([X, P, R], 1)
        theta, Q = _eigh_descending(XPR.T @ A(XPR))  # Rayleigh-Ritz on XPR
        B = Q[:, :k]
        X = XPR @ (B / _col_norms(B))
        X = X / _col_norms(X)
        # P: the rotation's difference directions, orthonormalized in the
        # Ritz basis before mapping through the orthonormal XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = _col_norms(P)
        P = P / torch.where(normP == 0, 1.0, normP)
        AX = A(X)
        R = AX - theta[None, :k] * X
        reltol = (_col_norms(AX)[0] + theta[:k]) * n * 10
        converged = int((_col_norms(R)[0] < tol * reltol).sum())  # host sync
        theta = theta[None, :k]
        i += 1
    return theta[0], X, i


# ---------------------------------------------------------------------------
# the lattice Laplacian and the segmentation
# ---------------------------------------------------------------------------


def _adjacency(plan: PermutohedralPlan, U: torch.Tensor) -> torch.Tensor:
    """(W_sym − I)·U by the lattice (self-excluded affinity). The blur's
    d+1 passes run in a fixed order, so the filter is symmetric only up to
    that order; averaging it with the reversed (transposed) filter makes
    the operator exactly self-adjoint, as LOBPCG needs."""
    return 0.5 * (apply_plan(plan, U) + apply_plan(plan, U, reverse=True)) - U


def laplacian_matvec(plan: PermutohedralPlan, degree: torch.Tensor, U: torch.Tensor,
                     normalize: str = "sym") -> torch.Tensor:
    """The graph Laplacian applied to U; `degree` = (W−I)·1.

    sym:  U − D^{-1/2} (W−I) (D^{-1/2} U)
    none: D·U − (W−I) U
    """
    if normalize == "sym":
        dinv = torch.rsqrt(torch.clamp_min(degree, 1e-12))
        return U - dinv * _adjacency(plan, dinv * U)
    if normalize == "none":
        return degree * U - _adjacency(plan, U)
    raise ValueError(normalize)


def spectral_embedding(ref: torch.Tensor, k: int, niters: int = 100,
                       guard: int = 2) -> torch.Tensor:
    """(n, k) smallest eigenvectors of the normalized lattice Laplacian of
    the (n, d) pre-scaled features `ref` (the ~constant one first).

    `guard` extra eigenpairs are solved and dropped: LOBPCG's trailing
    block eigenpair converges far slower than the interior ones. The start
    block is drawn on the CPU by a `torch.Generator` seeded with 0, so
    a CPU and a GPU run start alike (not as `jax.random` does: parity with
    the JAX package is on eigenvalues and subspaces)."""
    n = ref.shape[0]
    plan = build_plan(ref)
    degree = torch.clamp_min(_adjacency(plan, torch.ones(n, 1, dtype=ref.dtype,
                                                        device=ref.device)), 1e-3)

    def A(U):  # 2I − L: its largest eigenpairs are L's smallest (λ(L) ∈ [0, 2])
        return 2.0 * U - laplacian_matvec(plan, degree, U, "sym")

    kk = min(k + guard, max(n // 2 - 1, k))
    g = torch.Generator().manual_seed(0)
    X0 = torch.randn(n, kk, generator=g, dtype=ref.dtype).to(ref.device)
    _, U, _ = lobpcg_standard(A, X0, m=niters)
    return U[:, :k]


def kmeans(X: torch.Tensor, k: int, niters: int = 20, seed: int = 0) -> torch.Tensor:
    """Fixed-iteration Lloyd's k-means from k distinct points drawn by a
    CPU `torch.Generator` seeded with `seed`; returns (n,) int32 labels."""
    def nearest(centers):
        return ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1).argmin(-1)

    g = torch.Generator().manual_seed(seed)
    centers = X[torch.randperm(X.shape[0], generator=g)[:k].to(X.device)]
    for _ in range(niters):
        onehot = torch.nn.functional.one_hot(nearest(centers), k).to(X.dtype)
        counts = onehot.sum(0)[:, None]
        new_centers = (onehot.T @ X) / torch.clamp_min(counts, 1.0)
        centers = torch.where(counts > 0, new_centers, centers)
    return nearest(centers).to(torch.int32)


def spectral_segment(img, num_segments: int = 6, num_eigs: int = 8, sigma_color: float = 0.15,
                     sigma_pos: float = 0.08, device=None) -> torch.Tensor:
    """(h, w, 3) image → (h, w) int32 segment labels: the bilateral
    Laplacian's eigenvectors, the trivial one dropped and rows normalized
    (Ng-Jordan-Weiss), k-means over the embedding. Runs on `device` (None:
    the GPU)."""
    img = _as_image(img, resolve_device(device))
    h, w = img.shape[:2]
    ref = stack_guide(img, sigma_color, sigma_pos).reshape(h * w, -1)
    emb = spectral_embedding(ref, num_eigs)[:, 1:]
    emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)
    return kmeans(emb, num_segments).reshape(h, w)
