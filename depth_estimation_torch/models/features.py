"""Guidance feature extractors, CNN features for the CRF's edge weights
(counterpart of the JAX package's `models/features.py`).

- `FeatureCNN`: conv stages at 1×, 1/2×, 1/4×, 1/8×, each resized back to
  the input resolution, concatenated and 1×1-projected to `out_dim`.
- `VGG16Features`: VGG16's relu1_2 / relu2_2 / relu3_3 / relu4_3 taps,
  resized back and concatenated to (h, w, 960). No pretrained weights ship
  with the repository: random init, or weights loaded by
  `utils.weights.load_jax_params`.
- `random_features`: a seeded random projection of local patches,
  whitened per channel.

Images and features are channels-last (h, w, c). Parameter names follow
the JAX package's flax trees (`Conv_0`, `GroupNorm_0`, `conv0_0`, ...), so
`load_jax_params` maps them by name. Flax defaults are kept: GroupNorm's
epsilon 1e-6, 'SAME' 3×3 convolutions; bilinear resizing is half-pixel
(`align_corners=False`), without antialiasing since it only upsamples.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device

__all__ = ["FeatureCNN", "VGG16Features", "random_features", "seeded_init", "VGG16_MEAN",
           "VGG16_STD"]

_VGG16_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512))
VGG16_MEAN = (0.485, 0.456, 0.406)
VGG16_STD = (0.229, 0.224, 0.225)


def _resize_to(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(1, c, h', w') → (1, c, h, w) bilinear, half-pixel centres."""
    if y.shape[-2:] == (h, w):
        return y
    return F.interpolate(y, size=(h, w), mode="bilinear", align_corners=False)


def seeded_init(module: nn.Module, generator: torch.Generator | None) -> None:
    """Convolution, transposed convolution and linear weights ~ N(0,
    1/fan_in) (the scale of flax's lecun_normal, untruncated), biases zero,
    from `generator` (seeded 0 if None), in module order; norms keep their
    ones and zeros. Fan-in counts the input channels and the kernel window."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=generator, dtype=w.dtype) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()


class FeatureCNN(nn.Module):
    """Multi-scale guidance features, (h, w, 3) → (h, w, out_dim); the JAX
    package's `FeatureCNN` (flax names `Conv_k`, `GroupNorm_k`)."""

    def __init__(self, out_dim: int = 64, widths: tuple = (32, 64, 96, 128), in_ch: int = 3,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.widths = tuple(widths)
        cin = in_ch
        for i, width in enumerate(self.widths):
            for k in (2 * i, 2 * i + 1):
                self.add_module(f"Conv_{k}", nn.Conv2d(cin, width, 3, padding=1))
                self.add_module(f"GroupNorm_{k}", nn.GroupNorm(8, width, eps=1e-6))
                cin = width
        self.add_module(f"Conv_{2 * len(self.widths)}", nn.Conv2d(sum(self.widths), out_dim, 1))
        seeded_init(self, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[:2]
        y = x.permute(2, 0, 1)[None]
        feats = []
        for i in range(len(self.widths)):
            for k in (2 * i, 2 * i + 1):
                y = F.relu(getattr(self, f"GroupNorm_{k}")(getattr(self, f"Conv_{k}")(y)))
            feats.append(_resize_to(y, h, w))
            if i < len(self.widths) - 1:
                y = F.avg_pool2d(y, 2)
        out = getattr(self, f"Conv_{2 * len(self.widths)}")(torch.cat(feats, dim=1))
        return out[0].permute(1, 2, 0)


class VGG16Features(nn.Module):
    """VGG16 taps relu1_2 / relu2_2 / relu3_3 / relu4_3 of an ImageNet-
    normalized (h, w, 3) image, each resized back, as (h, w, 960); the JAX
    package's `VGG16Features` (names `conv{stage}_{layer}`)."""

    def __init__(self, generator: torch.Generator | None = None, device=None):
        super().__init__()
        cin = 3
        for s, widths in enumerate(_VGG16_STAGES):
            for c, width in enumerate(widths):
                self.add_module(f"conv{s}_{c}", nn.Conv2d(cin, width, 3, padding=1))
                cin = width
        seeded_init(self, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[:2]
        mean = torch.tensor(VGG16_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(VGG16_STD, dtype=x.dtype, device=x.device)
        y = ((x - mean) / std).permute(2, 0, 1)[None]
        taps = []
        for s, widths in enumerate(_VGG16_STAGES):
            for c in range(len(widths)):
                y = F.relu(getattr(self, f"conv{s}_{c}")(y))
            taps.append(_resize_to(y, h, w))
            y = F.max_pool2d(y, 2)
        return torch.cat(taps, dim=1)[0].permute(1, 2, 0)


def random_features(img: torch.Tensor, out_dim: int = 16, patch: int = 3,
                    generator: torch.Generator | None = None,
                    proj: torch.Tensor | None = None) -> torch.Tensor:
    """Random projection of the (patch × patch, edge-padded) neighbourhood
    of every pixel, whitened per channel. `proj` is the raw (patch²·c,
    out_dim) standard-normal draw; without it one is drawn from
    `generator` (seeded 0 if None). It is scaled by 1/sqrt(patch²·c)."""
    h, w, c = img.shape
    r = patch // 2
    padded = F.pad(img.permute(2, 0, 1)[None], (r, r, r, r), mode="replicate")[0].permute(1, 2, 0)
    patches = torch.cat([padded[di: di + h, dj: dj + w] for di in range(patch)
                         for dj in range(patch)], dim=-1)
    k = patches.shape[-1]
    if proj is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        proj = torch.randn(k, out_dim, generator=generator, dtype=img.dtype)
    proj = proj.to(device=img.device, dtype=img.dtype)
    feats = patches @ (proj / torch.sqrt(torch.tensor(float(k), dtype=img.dtype)))
    mean = feats.mean(dim=(0, 1), keepdim=True)
    std = feats.std(dim=(0, 1), keepdim=True, unbiased=False)
    return (feats - mean) / (std + 1e-6)
