"""End-to-end dense-CRF stereo inference (counterpart of
the JAX package's `models/pipeline.py`):

  stereo pair → cost volume (unary E0) → bilateral guide [rgb/σc, ij/σp]
  → mean-field CRF (message passing = dense oracle | permutohedral lattice)
  → softmax-expectation disparity decode.

With `fused_update` each iteration is one lattice filter and one launch of
a CUDA kernel through `ops.cuda.meanfield.fused_energy_update`: K1 at 8,
16, 32 or 64 labels, K1w at any other count up to 256, K1x up to 1024,
K1xx above (its plain version on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..crf.compat import charbonnier2, compatibility_matrix
from ..crf.guides import stack_guide
from ..crf.meanfield import _matmul_like, mean_field_infer
from ..ops.costvolume import cost_volume, expected_disparity
from ..ops.cuda.meanfield import fused_energy_update
from ..ops.dense_gaussian import dense_gaussian_filter
from ..ops.permutohedral import (apply_plan, build_plan, rotation_matrices,
                                 suggest_capacity, suggest_sort_mode, suggest_tile_u)
from ..utils.device import resolve_device
from ..utils.profiling import span

__all__ = ["CRFStereoConfig", "stereo_unary", "calibrate_capacity", "crf_stereo_infer",
           "blocked", "unblocked"]


@dataclass(frozen=True)
class CRFStereoConfig:
    """Pipeline hyperparameters; the fields and defaults of the JAX
    package's `CRFStereoConfig` but the two that change nothing here
    (`utils.weights.JAX_ONLY_FIELDS`)."""

    num_disp: int = 16
    window_size: int = 9
    gamma: float = 3.0
    sigma_color: float = 0.1
    sigma_pos: float = 0.1
    niters: int = 5
    unary_scale: float = 1.0
    backend: str = "lattice"  # 'lattice' | 'dense'
    mu_scale: float = 1.0
    # lattice vertex capacity; None = pow2 ≥ 2n (capped at n·(d+1))
    max_vertices: int | None = None
    # average k rotated lattices (k× plan + apply cost)
    num_lattices: int = 1
    # prepend the coordinate sum to the plan's sort columns
    order_by_sum: bool = False
    # tiled splat/slice: tile_px × tile_px image blocks, ≤ tile_u vertices
    # per block, incidence blocks in bf16 if tile_bf16
    tile_px: int | None = None
    tile_u: int = 512
    tile_bf16: bool = False
    # plan sort strategy; 'packed1' with tile_px takes the lean plan build
    sort_mode: str = "auto"
    # mean-field state dtype: 'f32' or 'bf16'
    compute_dtype: str = "f32"
    # one fused CUDA update per iteration (lattice backend only)
    fused_update: bool = False


def _as_image(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


def _edge_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """(h, w, c) padded at the bottom and right by repeating the edge."""
    return F.pad(x.permute(2, 0, 1), (0, pad_w, 0, pad_h), mode="replicate").permute(1, 2, 0)


def blocked(x: torch.Tensor, B: int) -> torch.Tensor:
    """(h, w, K) → (h·w, K) in B × B block order."""
    h, w, K = x.shape
    return x.reshape(h // B, B, w // B, B, K).permute(0, 2, 1, 3, 4).reshape(h * w, K)


def unblocked(flat: torch.Tensor, h: int, w: int, B: int) -> torch.Tensor:
    """Inverse of `blocked`, to (h, w, K)."""
    K = flat.shape[-1]
    return flat.reshape(h // B, w // B, B, B, K).permute(0, 2, 1, 3, 4).reshape(h, w, K)


@span("stereo.unary")
def stereo_unary(left: torch.Tensor, right: torch.Tensor, cfg: CRFStereoConfig) -> torch.Tensor:
    """Unary energies (h, w, L): raw window sums of the matching cost,
    times `unary_scale` (on the card, in the kernel's store)."""
    return cost_volume(left, right, cfg.num_disp, cfg.window_size, scale=cfg.unary_scale)


def calibrate_capacity(
    left,
    cfg: CRFStereoConfig,
    headroom: float = 3.0,
    tiled: bool = False,
    tile_px: int = 32,
    max_incidence_bytes: int = 1 << 30,
    device=None,
) -> CRFStereoConfig:
    """A config sized to THIS image's guide: `max_vertices` = pow2 ≥
    headroom·occupancy, the plan sort mode, and with `tiled` the tile size
    and per-tile capacity (skipped when the incidence blocks would exceed
    `max_incidence_bytes`). 'packed1' is pinned only when the guide's
    packed key fits and `order_by_sum` is off."""
    if cfg.backend != "lattice":
        return cfg
    dev = resolve_device(device)
    left = _as_image(left, dev)
    h, w, _ = left.shape
    guide = stack_guide(left, cfg.sigma_color, cfg.sigma_pos)
    ref = guide.reshape(-1, guide.shape[-1])
    cap = suggest_capacity(ref, headroom=headroom)
    sort_mode = "auto" if cfg.order_by_sum else suggest_sort_mode(ref)
    tile_kw = {}
    if tiled:
        B = tile_px
        hp, wp = h + (-h % B), w + (-w % B)
        gp = _edge_pad(guide, hp - h, wp - w) if (hp, wp) != (h, w) else guide
        tu = suggest_tile_u(blocked(gp, B), B * B, cap)
        if hp * wp * tu * 4 <= max_incidence_bytes:
            tile_kw = {"tile_px": B, "tile_u": tu}
    return replace(cfg, max_vertices=cap, sort_mode=sort_mode, **tile_kw)


@span("stereo.frame")
def crf_stereo_infer(left, right, cfg: CRFStereoConfig, device=None) -> dict:
    """Full pipeline on an (h, w, 3) pair. Returns the CRF and unary
    disparities, the label probabilities and unaries (all (h, w, ...)), and
    the lattice plans it built (`plans`, empty for the dense backend)."""
    dev = resolve_device(device)
    left, right = _as_image(left, dev), _as_image(right, dev)
    h0, w0, _ = left.shape
    lattice = cfg.backend == "lattice"
    B = cfg.tile_px
    # tiled mode needs block-divisible dims: edge-pad, crop outputs back
    pad_h = (-h0 % B) if (lattice and B) else 0
    pad_w = (-w0 % B) if (lattice and B) else 0
    if pad_h or pad_w:
        left, right = _edge_pad(left, pad_h, pad_w), _edge_pad(right, pad_h, pad_w)
    h, w, _ = left.shape
    E0 = stereo_unary(left, right, cfg)

    labels = torch.arange(cfg.num_disp, dtype=left.dtype, device=dev)
    Mu = compatibility_matrix(lambda a, b: charbonnier2(a, b, cfg.gamma), labels)
    Mu = Mu * cfg.mu_scale
    guide = stack_guide(left, cfg.sigma_color, cfg.sigma_pos)

    # tiled mode flattens pixels in block order so that each plan tile is
    # a square image patch; only the final reshape undoes it
    tiled = lattice and B is not None and h % B == 0 and w % B == 0
    if tiled:
        ref, E0_flat = blocked(guide, B), blocked(E0, B)
    else:
        ref, E0_flat = guide.reshape(h * w, -1), E0.reshape(h * w, cfg.num_disp)

    plans = []
    if lattice:
        cap = cfg.max_vertices
        if cap is None:
            cap = min(1 << (2 * h * w - 1).bit_length(), ref.shape[0] * (ref.shape[1] + 1))
        plans = [
            build_plan(ref if m == 0 else ref @ torch.as_tensor(R, dtype=ref.dtype, device=dev),
                       max_vertices=cap, order_by_sum=cfg.order_by_sum,
                       tile=B * B if tiled else None, tile_u=cfg.tile_u,
                       tile_bf16=cfg.tile_bf16, sort_mode=cfg.sort_mode)
            for m, R in enumerate(rotation_matrices(ref.shape[1], cfg.num_lattices))
        ]

        def filt(x, shift_rows=False):
            out = apply_plan(plans[0], x, shift_rows=shift_rows)
            if len(plans) == 1:
                return out
            for p in plans[1:]:
                out = out + apply_plan(p, x, shift_rows=shift_rows)
            return out / len(plans)

        def message_fn(Q):
            return filt(Q) - Q
    elif cfg.backend == "dense":
        def message_fn(Q):
            return dense_gaussian_filter(Q, ref) - Q
    else:
        raise ValueError(cfg.backend)

    if cfg.compute_dtype == "bf16":
        E0_flat, Mu = E0_flat.to(torch.bfloat16), Mu.to(torch.bfloat16)
    elif cfg.compute_dtype != "f32":
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if lattice and cfg.fused_update and cfg.niters > 0:
        # the compat-transformed beliefs C = Q·Mu are the filter input, so
        # each iteration is one lattice apply and one fused update. A bf16
        # state keeps its rows near 0: the message S is shifted to a minimum
        # of 0 a row before it is rounded, and the lattice's table every
        # second blur pass (`apply_plan`'s shift_rows). The softmax, and so
        # Q, C' and the disparity, ignore a constant a row, while bf16's
        # error grows with the magnitude: at 994x1482 and 320 labels S
        # reaches 3.5e6 and its rows' minima 6e4, where a bf16 step is 256
        narrow = E0_flat.dtype == torch.bfloat16
        C = _matmul_like(torch.softmax(-E0_flat, dim=-1), Mu)
        E = E0_flat
        for _ in range(cfg.niters):
            S = filt(C, shift_rows=narrow)
            if narrow:
                S = torch.sub(S, S.amin(1, keepdim=True), out=torch.empty_like(E0_flat))
            else:
                S = S.to(E0_flat.dtype).contiguous()
            E, C = fused_energy_update(E0_flat.contiguous(), S, C, Mu.contiguous())
        Q = torch.softmax(-E, dim=-1).float()
        logits = (-E).float()
    else:
        Q = mean_field_infer(E0_flat, message_fn, Mu, cfg.niters).float()
        logits = torch.log(Q + 1e-20)
    if tiled:
        Qimg = unblocked(Q, h, w, B)
        disp_crf = expected_disparity(unblocked(logits, h, w, B))
    else:
        Qimg = Q.reshape(h, w, cfg.num_disp)
        disp_crf = expected_disparity(logits).reshape(h, w)
    disp_unary = expected_disparity(-E0)
    return {
        "disparity": disp_crf[:h0, :w0],
        "disparity_unary": disp_unary[:h0, :w0],
        "probabilities": Qimg[:h0, :w0],
        "unary": E0[:h0, :w0],
        "plans": plans,
    }
