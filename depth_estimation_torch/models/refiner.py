"""Task models: the CRF-as-RNN layer, the CRF depth refiner, its
uncertainty variant and the depth upsampler (counterpart of the JAX
package's `models/refiner.py`, whose init/apply pairs become `nn.Module`s).

The CRF layer has two message-passing backends:

- 'guided': the fast guided-filter adjacency (`ops.guided_filter`), O(n)
  and radius-controlled, with a trainable regularizer per guide channel;
- 'lattice': the permutohedral bilateral adjacency over the trainable
  guide [ij/s_ij, rgb/s_rgb], through `lattice_filter_planned`: one plan,
  built from the detached guide, serves every iteration and the backward.

Parameter names are the JAX package's tree keys joined by dots
(`crf.mu.gamma`, `crf.w.s_ij`, `proj_w`, `unc.0.w`, ...), so
`utils.weights.load_jax_params` maps them by name; convolution weights are
stored OIHW. Random draws come from an explicit `torch.Generator`.
Layout: channels-last; logits (h, w, L), guides (h, w, c).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..crf.compat import charb_apply, charb_energies_from_scalar, charb_init
from ..crf.guides import ijrgb_guide, ijrgb_guide_init
from ..crf.meanfield import crf_as_rnn
from ..ops.costvolume import expected_disparity
from ..ops.guided_filter import guided_adjacency_apply, guided_adjacency_init
from ..ops.permutohedral import build_plan, lattice_filter_planned
from ..utils.device import resolve_device
from .pipeline import blocked, unblocked

__all__ = ["CRFasRNN", "CRFDepthRefiner", "CRFWithUncertainty", "CRFDepthUpsampler"]


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v.detach().clone()) for k, v in d.items()})


class CRFasRNN(nn.Module):
    """The trainable CRF layer; the JAX package's `crf_rnn_init` (params
    `mu.gamma`, `mu.log_s`, and `w.omega` or `w.s_ij`, `w.s_rgb`) and
    `crf_rnn_apply` (`forward`)."""

    def __init__(self, gamma: float = 0.05, gchannels: int = 1, eps: float = 1e-2,
                 backend: str = "guided", dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.backend = backend
        self.mu = _params(charb_init(gamma, dtype, dev))
        if backend == "guided":
            self.w = _params(guided_adjacency_init(gchannels, eps, dtype, dev))
        elif backend == "lattice":
            self.w = _params(ijrgb_guide_init(dtype=dtype, device=dev))
        else:
            raise ValueError(backend)

    def forward(self, guide: torch.Tensor, logits: torch.Tensor, niters: int = 2, r: int = 15,
                confidence: torch.Tensor | None = None, labels: torch.Tensor | None = None,
                subsample: int = 2, max_vertices: int | None = None, tile_px: int | None = None,
                tile_u: int = 512, tile_bf16: bool = False,
                sort_mode: str = "auto") -> torch.Tensor:
        """Refined logits (h, w, L). For the lattice backend the guide is
        rescaled by the trainable scales (positions prepended); `tile_px`
        block-reorders the pixels for the tiled splat/slice (tiles of
        tile_px² pixels, ≤ tile_u vertices each); `max_vertices` defaults
        to pow2 ≥ 2n (capped at n·(d+1))."""
        h, w, L = logits.shape

        def compat_fn(Q):
            return charb_apply(self.mu, Q, labels)

        if self.backend == "guided":
            def message_fn(Q):
                return guided_adjacency_apply(self.w, Q, guide, r, subsample)
        else:
            ref_img = ijrgb_guide(self.w, guide)
            B = tile_px
            tiled = B is not None and h % B == 0 and w % B == 0
            ref = blocked(ref_img, B) if tiled else ref_img.reshape(h * w, -1)
            cap = max_vertices or min(1 << (2 * h * w - 1).bit_length(),
                                      h * w * (ref.shape[1] + 1))
            plan = build_plan(ref.detach(), max_vertices=cap, tile=B * B if tiled else None,
                              tile_u=tile_u, tile_bf16=tile_bf16, sort_mode=sort_mode)

            def message_fn(Q):
                flat = blocked(Q, B) if tiled else Q.reshape(h * w, L)
                out = lattice_filter_planned(flat, ref, plan) - flat
                return unblocked(out, h, w, B) if tiled else out.reshape(h, w, L)
        return crf_as_rnn(logits, message_fn, compat_fn, niters, confidence)


class CRFDepthRefiner(nn.Module):
    """1×1 projection of CNN features (d_in → d_guide−3) next to the rgb
    image as the guide of a guided-backend CRF, decoded to depth; the JAX
    package's `refiner_init` / `refiner_apply`."""

    def __init__(self, d_in: int = 64, d_guide: int = 16, gamma: float = 0.05,
                 eps: float = 1e-2, dtype=torch.float32,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        w = torch.randn(d_in, d_guide - 3, generator=generator, dtype=dtype) / d_in ** 0.5
        self.proj_w = nn.Parameter(w.to(dev))
        self.proj_b = nn.Parameter(torch.zeros(d_guide - 3, dtype=dtype, device=dev))
        self.crf = CRFasRNN(gamma, d_guide, eps, "guided", dtype, dev)

    def guide(self, imgrgb: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        return torch.cat([imgrgb, features @ self.proj_w + self.proj_b], dim=-1)

    def forward(self, logits, imgrgb, features, niters: int = 2, r: int = 15) -> torch.Tensor:
        """(h, w, L) logits, (h, w, 3) rgb, (h, w, d_in) features → (h, w)."""
        refined = self.crf(self.guide(imgrgb, features), logits, niters, r)
        return expected_disparity(refined)


def _coord_cat(x: torch.Tensor) -> torch.Tensor:
    """Append (i, j) coordinate channels normalized to [0, 1]."""
    h, w = x.shape[:2]
    ii = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(h, w) / max(h - 1, 1)
    jj = torch.arange(w, dtype=x.dtype, device=x.device)[None, :].expand(h, w) / max(w - 1, 1)
    return torch.cat([x, ii[..., None], jj[..., None]], dim=-1)


def _groupnorm(x: torch.Tensor, groups: int = 4, eps: float = 1e-5) -> torch.Tensor:
    """Group normalization of (h, w, c) over (h, w, c/groups), no affine."""
    h, w, c = x.shape
    g = x.reshape(h, w, groups, c // groups)
    mean = g.mean(dim=(0, 1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(0, 1, 3), keepdim=True)
    return ((g - mean) * torch.rsqrt(var + eps)).reshape(h, w, c)


class _Conv(nn.Module):
    """'SAME' k×k convolution of an (h, w, cin) map; weight `w` is OIHW
    (the JAX tree's HWIO `w` transposed), bias `b`."""

    JAX_LAYOUTS = {"w": "conv"}  # how `utils.weights.load_jax_params` lays out `w`

    def __init__(self, cin: int, cout: int, k: int, dtype, generator, device):
        super().__init__()
        w = torch.randn(cout, cin, k, k, generator=generator, dtype=dtype) / (cin * k * k) ** 0.5
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros(cout, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(2, 0, 1)[None], self.w, self.b, padding=self.w.shape[-1] // 2)
        return y[0].permute(1, 2, 0)


class CRFWithUncertainty(CRFDepthRefiner):
    """The refiner plus a 3-layer coord-conv head producing the per-pixel
    confidence exp(−s) that weights the unaries; the JAX package's
    `uncertainty_init` / `uncertainty_apply`."""

    def __init__(self, d_in: int = 64, d_guide: int = 16, gamma: float = 0.05,
                 eps: float = 1e-2, dtype=torch.float32,
                 generator: torch.Generator | None = None, device=None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        super().__init__(d_in, d_guide, gamma, eps, dtype, generator, device)
        dev = self.proj_w.device
        self.unc = nn.ModuleList([_Conv(3 + 2, 16, 3, dtype, generator, dev),
                                  _Conv(16 + 2, 16, 3, dtype, generator, dev),
                                  _Conv(16 + 2, 1, 3, dtype, generator, dev)])

    def forward(self, logits, imgrgb, features, niters: int = 2, r: int = 15):
        """Returns (depth (h, w), confidence (h, w))."""
        s = F.relu(_groupnorm(self.unc[0](_coord_cat(imgrgb))))
        s = F.relu(_groupnorm(self.unc[1](_coord_cat(s))))
        confidence = torch.exp(-self.unc[2](_coord_cat(s)))  # (h, w, 1)
        refined = self.crf(self.guide(imgrgb, features), logits, niters, r, confidence=confidence)
        return expected_disparity(refined), confidence[..., 0]


class CRFDepthUpsampler(nn.Module):
    """Depth super-resolution: bilinear upsampling of the low-res
    disparity, Charbonnier energies against `num_labels` evenly spaced
    labels, the image-guided CRF with (disp > 1e-2) as confidence, and the
    expectation decode; the JAX package's `upsampler_init` /
    `upsampler_apply`."""

    def __init__(self, gamma: float = 0.05, eps: float = 1e-2, d_guide: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.crf = CRFasRNN(gamma, d_guide, eps, "guided", dtype, device)

    def forward(self, disp_lowres: torch.Tensor, img_highres: torch.Tensor, niters: int = 1,
                r: int = 5, num_labels: int = 18, unary_scale: float = 10.0) -> torch.Tensor:
        h, w = img_highres.shape[:2]
        up = F.interpolate(disp_lowres[None, None], size=(h, w), mode="bilinear",
                           align_corners=False)[0, 0]
        labels = torch.linspace(0.0, 1.0, num_labels, dtype=up.dtype, device=up.device) * up.max()
        energies = charb_energies_from_scalar(self.crf.mu, up[..., None], labels[None, None, :])
        logits = -unary_scale * energies
        confidence = (up > 1e-2).to(up.dtype)[..., None]
        refined = self.crf(img_highres, logits, niters, r, confidence=confidence, labels=labels)
        return expected_disparity(refined, labels)
