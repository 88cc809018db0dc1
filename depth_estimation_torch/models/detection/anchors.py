"""Anchor generation for FPN levels (counterpart of the JAX package's
`models/detection/anchors.py`): one scale per level, anchors centred on
the feature cells, (x1, y1, x2, y2) image coordinates.

The anchors of an image size are static, so they are built once in numpy
and kept on the device, per (feature shapes, device); the JAX package
rebuilds them on the host on every call.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["cell_anchors", "pyramid_anchors"]


def cell_anchors(scale: float, ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """(A, 4) anchors centred at the origin for one scale and each ratio."""
    out = []
    for r in ratios:
        h = scale * np.sqrt(r)
        w = scale / np.sqrt(r)
        out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


def pyramid_anchors_np(feature_shapes, strides, scales, ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """Concatenated (ΣA·h_l·w_l, 4) float32 anchors over all levels, in
    (level, row, column, ratio) order."""
    all_anchors = []
    for (h, w), stride, scale in zip(feature_shapes, strides, scales):
        base = cell_anchors(scale, ratios)
        ys = (np.arange(h) + 0.5) * stride
        xs = (np.arange(w) + 0.5) * stride
        cx, cy = np.meshgrid(xs, ys)
        centers = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
        all_anchors.append((centers + base[None]).reshape(-1, 4).astype(np.float32))
    return np.concatenate(all_anchors, axis=0)


@lru_cache(maxsize=16)
def _cached(feature_shapes, strides, scales, ratios, device: str) -> torch.Tensor:
    return torch.from_numpy(pyramid_anchors_np(feature_shapes, strides, scales, ratios)).to(device)


def pyramid_anchors(feature_shapes, strides, scales, ratios=(0.5, 1.0, 2.0),
                    device="cpu") -> torch.Tensor:
    """`pyramid_anchors_np` as a float32 tensor on `device`, built once per
    (shapes, strides, scales, ratios, device). The tensor is shared between
    callers: do not write to it."""
    key = tuple(tuple(int(v) for v in s) for s in feature_shapes)
    return _cached(key, tuple(strides), tuple(scales), tuple(ratios), str(torch.device(device)))
