"""Plain dense-CRF stereo: the disparity map the benchmark's inference cells
must produce, computed from the pair alone.

    E0[i, j, l] = Σ over a ws × ws window (numpy's 'symmetric' border) of
                  Σ_c |left[i, j, c] − right[i, j − l, c]|   (zeros left of column 0)
    positions   = [rgb / σc, (i, j) / √(h² + w²) / σp]
    Mu[l, m]    = (√(1 + ((l − m)/γ)²) − 1) · mu_scale
    C = softmax(−E0)·Mu;  niters × { E = E0 + filter(C) − C;  C = softmax(−E)·Mu }
    disparity   = Σ_l softmax(−E)_l · l

in float64 through the plain lattice of `reference.lattice`. `state`, where
given, is a lower precision to round the mean-field state to (E0, Mu, C,
the lattice's values, the filtered message and E, where an implementation
that keeps its state in that dtype rounds them), and `blocks` one to
round the lattice's barycentric weights to: the control puts this in the
program's place. It imports nothing of the program.
"""
from __future__ import annotations

import torch

from .lattice import Lattice

__all__ = ["cost_volume", "positions", "disparity"]

_F64 = torch.float64


def _symmetric(n: int, r: int, device) -> torch.Tensor:
    p = torch.arange(-r, n + r, device=device)
    return torch.where(p < 0, -p - 1, torch.where(p >= n, 2 * n - 1 - p, p))


def cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                window: int) -> torch.Tensor:
    """(h, w, num_disp) window sums of the absolute colour difference."""
    left, right = left.to(_F64), right.to(_F64)
    h, w, _ = left.shape
    cols = []
    for d in range(num_disp):
        shifted = torch.zeros_like(right)
        shifted[:, d:] = right[:, : w - d]
        cols.append((left - shifted).abs().sum(-1))
    vol = torch.stack(cols, -1)
    r = window // 2
    vol = vol[_symmetric(h, r, vol.device)][:, _symmetric(w, r, vol.device)]
    vol = sum(vol[k: k + h] for k in range(window))
    return sum(vol[:, k: k + w] for k in range(window))


def positions(img: torch.Tensor, sigma_color: float, sigma_pos: float) -> torch.Tensor:
    """(h·w, 5) bilateral positions of an (h, w, 3) image, row-major."""
    h, w, _ = img.shape
    ii, jj = torch.meshgrid(torch.arange(h, dtype=_F64, device=img.device),
                            torch.arange(w, dtype=_F64, device=img.device), indexing="ij")
    ij = torch.stack([ii, jj], -1) / ((h ** 2 + w ** 2) ** 0.5 * sigma_pos)
    return torch.cat([img.to(_F64) / sigma_color, ij], -1).reshape(h * w, 5)


def _rounder(dtype):
    """x rounded to `dtype`; an 8-bit float is scaled per tensor so that
    its largest magnitude maps to the format's largest, as an fp8
    implementation scales its tensors."""
    if dtype is None:
        return lambda x: x
    if dtype.itemsize > 1:
        return lambda x: x.to(dtype).to(_F64)
    top = torch.finfo(dtype).max

    def scaled(x):
        scale = (x.abs().amax() / top).clamp_min(torch.finfo(_F64).tiny)
        return (x / scale).to(dtype).to(_F64) * scale
    return scaled


def disparity(left: torch.Tensor, right: torch.Tensor, cfg: dict, state=None,
              blocks=None) -> torch.Tensor:
    """(h, w) CRF disparity of one pair under configuration `cfg` (the
    keys num_disp, window_size, gamma, mu_scale, sigma_color, sigma_pos,
    niters of a configuration file)."""
    h, w, _ = left.shape
    L = cfg["num_disp"]
    rs = _rounder(state)
    rv = None if state is None else rs
    rb = None if blocks is None else _rounder(blocks)
    E0 = rs(cost_volume(left, right, L, cfg["window_size"]).reshape(h * w, L))
    labels = torch.arange(L, dtype=_F64, device=left.device)
    Mu = rs((torch.sqrt(1 + ((labels[:, None] - labels[None, :]) / cfg["gamma"]) ** 2) - 1)
            * cfg.get("mu_scale", 1.0))
    lattice = Lattice(positions(left, cfg["sigma_color"], cfg["sigma_pos"]))
    C = rs(torch.softmax(-E0, -1) @ Mu)
    E = E0
    for _ in range(cfg["niters"]):
        S = rs(lattice.apply(C, values=rv, weights=rb))
        E = rs(E0 + S - C)
        C = rs(torch.softmax(-E, -1) @ Mu)
    return (torch.softmax(-E, -1) @ labels).reshape(h, w)
