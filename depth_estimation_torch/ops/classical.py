"""Classical depth-refinement baselines, no learning and no mean field
(counterpart of the JAX package's `ops/classical.py`).

Iterated edge-aware smoothing of a noisy (h, w) disparity (joint-bilateral
by the permutohedral lattice, or guided filtering), and linear-system
refinement: conjugate-gradient solves of (I + λ·Lap) d = d₀ with a grid or
a bilateral Laplacian. Every operator is matrix-free. CG is the port's own
loop with the stopping rule of `jax.scipy.sparse.linalg.cg`: from `x0`,
stop once ‖r‖² ≤ max(tol²·‖b‖², atol²) (tol 1e-5, atol 0) or after
`maxiter` steps; the test is a host sync each iteration.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..crf.guides import stack_guide
from .guided_filter import guided_filter
from .permutohedral import apply_plan, build_plan

__all__ = [
    "joint_bilateral_smooth",
    "iterated_guided_smooth",
    "laplacian_apply",
    "cg",
    "cg_refine_laplacian",
    "cg_refine_bilateral",
]


def joint_bilateral_smooth(disp: torch.Tensor, img: torch.Tensor, sigma_color: float = 0.1,
                           sigma_pos: float = 0.02, niters: int = 3) -> torch.Tensor:
    """Iterated joint-bilateral filtering of (h, w) disparity guided by the
    (h, w, 3) image: homogeneous-normalized lattice filtering."""
    h, w = disp.shape
    plan = build_plan(stack_guide(img, sigma_color, sigma_pos).reshape(h * w, -1))
    for _ in range(niters):
        out = apply_plan(plan, torch.stack([disp.reshape(-1), torch.ones_like(disp).reshape(-1)],
                                           dim=-1))
        disp = (out[:, 0] / torch.clamp_min(out[:, 1], 1e-20)).reshape(h, w)
    return disp


def iterated_guided_smooth(disp: torch.Tensor, img: torch.Tensor, r: int = 8, eps: float = 1e-3,
                           niters: int = 3) -> torch.Tensor:
    """Iterated guided filtering of (h, w) disparity by the image."""
    for _ in range(niters):
        disp = guided_filter(disp[..., None], img, r, eps)[..., 0]
    return disp


def laplacian_apply(x: torch.Tensor) -> torch.Tensor:
    """5-point graph Laplacian of an (h, w) map with zero-flux borders (each
    missing neighbour is the pixel itself)."""
    up = torch.cat([x[:1], x[:-1]])
    down = torch.cat([x[1:], x[-1:]])
    left = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    return 4.0 * x - up - down - left - right


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


def cg(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor, x0: torch.Tensor,
       maxiter: int, tol: float = 1e-5, atol: float = 0.0) -> torch.Tensor:
    """Conjugate gradients for the SPD operator `A`, with the stopping rule
    of `jax.scipy.sparse.linalg.cg` (no preconditioner)."""
    atol2 = max(tol ** 2 * float(_vdot(b, b)), atol ** 2)
    x = x0
    r = b - A(x0)
    p, gamma = r, _vdot(r, r)
    k = 0
    while k < maxiter and float(gamma) > atol2:  # host sync each iteration
        Ap = A(p)
        alpha = gamma / _vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = _vdot(r, r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


def cg_refine_laplacian(disp: torch.Tensor, lam: float = 1.0, maxiter: int = 50) -> torch.Tensor:
    """Solve (I + λ·Lap) d = d₀ by CG from d₀: quadratic smoothing."""
    return cg(lambda x: x + lam * laplacian_apply(x), disp, disp, maxiter)


def cg_refine_bilateral(disp: torch.Tensor, img: torch.Tensor, lam: float = 1.0,
                        sigma_color: float = 0.1, sigma_pos: float = 0.02,
                        maxiter: int = 30) -> torch.Tensor:
    """Solve (I + λ·L_bilateral) d = d₀ by CG from d₀, with the normalized
    symmetrized lattice RBF Laplacian: edge-aware quadratic refinement."""
    h, w = disp.shape
    plan = build_plan(stack_guide(img, sigma_color, sigma_pos).reshape(h * w, -1))

    def Wsym(U):
        return 0.5 * (apply_plan(plan, U) + apply_plan(plan, U, reverse=True)) - U

    dinv = torch.rsqrt(torch.clamp_min(Wsym(torch.ones(h * w, 1, dtype=disp.dtype,
                                                       device=disp.device)), 1e-6))

    def A(x):
        u = x.reshape(h * w, 1)
        return (u + lam * (u - dinv * Wsym(dinv * u))).reshape(h, w)

    return cg(A, disp, disp, maxiter)
