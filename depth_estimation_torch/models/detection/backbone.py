"""ResNet backbones and the FPN neck (counterpart of the JAX package's
`models/detection/backbone.py`).

Two norm modes, as there: ``norm='gn'`` (GroupNorm, 32 groups, epsilon
1e-6, flax's default and not torch's 1e-5) and ``norm='affine'`` (frozen
per-channel scale·x + bias, the target of pretrained-weight import).
Paddings are explicit and torch/Caffe2-aligned (stem 7×7 pad 3, 3×3 convs
pad 1, stem max pool pad 1); ``stride_1x1`` puts a block's stride on its
first 1×1 conv (Detectron, Keras) instead of the 3×3 (torchvision).

The FPN's top-down upsampling is `nearest-exact`: the JAX package's
`jax.image.resize(..., "nearest")` samples at half-pixel centres, which
torch's plain `nearest` does not (equal at 2×, not at the odd sizes of an
800×1024 image, P5 25×32 and P6 13×16).

Maps are NCHW inside; module and parameter names are the flax tree's
(`Conv_k`, `GroupNorm_k`, `AffineChannel_k`, `Bottleneck_k`, ...), so
`utils.weights.load_jax_params` maps them by name.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["AffineChannel", "Bottleneck", "ResNet", "FPN", "ResNetFPN", "resnet50_fpn",
           "GN_EPS"]

GN_EPS = 1e-6  # flax GroupNorm's epsilon


class AffineChannel(nn.Module):
    """Per-channel weight·x + bias over NCHW maps: frozen BatchNorm with its
    statistics folded in (Detectron `AffineChannel2d`). `weight` is the
    flax tree's `scale`."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def _norm(kind: str, c: int) -> nn.Module:
    if kind == "gn":
        return nn.GroupNorm(32, c, eps=GN_EPS)
    if kind == "affine":
        return AffineChannel(c)
    raise ValueError(f"unknown norm {kind!r}")


def _norm_name(kind: str) -> str:
    return "GroupNorm" if kind == "gn" else "AffineChannel"


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 residual block, with a projection shortcut (which
    carries the stride) when the width or the size changes."""

    def __init__(self, cin: int, width: int, stride: int = 1, norm: str = "gn",
                 stride_1x1: bool = False):
        super().__init__()
        out_dim = width * 4
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        n = _norm_name(norm)
        self.Conv_0 = nn.Conv2d(cin, width, 1, stride=s1, bias=False)
        self.Conv_1 = nn.Conv2d(width, width, 3, stride=s3, padding=1, bias=False)
        self.Conv_2 = nn.Conv2d(width, out_dim, 1, bias=False)
        for k, c in enumerate((width, width, out_dim)):
            self.add_module(f"{n}_{k}", _norm(norm, c))
        self.project = cin != out_dim or stride != 1
        if self.project:
            self.Conv_3 = nn.Conv2d(cin, out_dim, 1, stride=stride, bias=False)
            self.add_module(f"{n}_3", _norm(norm, out_dim))
        self._norms = [f"{n}_{k}" for k in range(4 if self.project else 3)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n0, n1, n2 = (getattr(self, k) for k in self._norms[:3])
        y = F.relu(n0(self.Conv_0(x)))
        y = F.relu(n1(self.Conv_1(y)))
        y = n2(self.Conv_2(y))
        residual = getattr(self, self._norms[3])(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Bottleneck ResNet body; `blocks=(3, 4, 6, 3)` is ResNet-50.
    (1, 3, h, w) → [C2, C3, C4, C5]."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3), base_width: int = 64,
                 norm: str = "gn", stride_1x1: bool = False):
        super().__init__()
        self.blocks = tuple(blocks)
        self.Conv_0 = nn.Conv2d(3, base_width, 7, stride=2, padding=3, bias=False)
        self.add_module(f"{_norm_name(norm)}_0", _norm(norm, base_width))
        self._stem_norm = f"{_norm_name(norm)}_0"
        cin, width, i = base_width, base_width, 0
        for stage, nblocks in enumerate(self.blocks):
            for j in range(nblocks):
                stride = 2 if stage > 0 and j == 0 else 1
                self.add_module(f"Bottleneck_{i}", Bottleneck(cin, width, stride, norm, stride_1x1))
                cin, i = width * 4, i + 1
            width *= 2
        self.out_channels = [base_width * 4 * 2 ** s for s in range(len(self.blocks))]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        y = F.relu(getattr(self, self._stem_norm)(self.Conv_0(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        feats, i = [], 0
        for nblocks in self.blocks:
            for _ in range(nblocks):
                y = getattr(self, f"Bottleneck_{i}")(y)
                i += 1
            feats.append(y)
        return feats


class FPN(nn.Module):
    """Top-down + lateral feature pyramid: P2..P5 from C2..C5 and P6 by
    stride-2 subsampling of P5 (lateral convs `Conv_0..3`, output convs
    `Conv_4..7`, as flax names them)."""

    def __init__(self, in_channels: Sequence[int], out_dim: int = 256):
        super().__init__()
        n = len(in_channels)
        self.n = n
        for k, c in enumerate(in_channels):
            self.add_module(f"Conv_{k}", nn.Conv2d(c, out_dim, 1))
        for k in range(n):
            self.add_module(f"Conv_{n + k}", nn.Conv2d(out_dim, out_dim, 3, padding=1))

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        laterals = [getattr(self, f"Conv_{k}")(c) for k, c in enumerate(feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(outs[0], size=lat.shape[-2:], mode="nearest-exact")
            outs.insert(0, lat + up)
        pyramid = [getattr(self, f"Conv_{self.n + k}")(p) for k, p in enumerate(outs)]
        return pyramid + [pyramid[-1][:, :, ::2, ::2]]  # [P2, P3, P4, P5, P6]


class ResNetFPN(nn.Module):
    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3), out_dim: int = 256,
                 norm: str = "gn", stride_1x1: bool = False, base_width: int = 64):
        super().__init__()
        self.ResNet_0 = ResNet(blocks, base_width=base_width, norm=norm, stride_1x1=stride_1x1)
        self.FPN_0 = FPN(self.ResNet_0.out_channels, out_dim)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.FPN_0(self.ResNet_0(x))


def resnet50_fpn(out_dim: int = 256) -> ResNetFPN:
    return ResNetFPN(blocks=(3, 4, 6, 3), out_dim=out_dim)
