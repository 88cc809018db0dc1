"""Detection primitives: box ops, NMS, ROI-Align (counterpart of the JAX
package's `ops/detection.py`).

The JAX package writes these as plain XLA ops, with no Pallas kernel, and
the port writes them as PyTorch ops:

- `nms`: greedy suppression with a fixed trip count over a precomputed IoU
  matrix: `max_outputs` steps of masked argmax and suppression, all on the
  device (no `.item()`, `nonzero` or boolean-mask indexing in the loop),
  returning (indices padded with -1, valid);
- `roi_align`, `roi_align_pyramid`: gather-based bilinear sampling,
  differentiable in the features and the boxes. The clipping is the JAX
  package's: the lower tap index is clipped first and the upper one is the
  clipped lower plus one, clipped again, while the weights come from the
  unclipped floor. For samples in [-1, 0) this differs from torchvision's
  and Caffe2's ROI-Align;
- Detectron box codecs, IoU, clipping, max ROI pooling and the STN-style
  ROI crop.

Boxes are (x1, y1, x2, y2) pixel coordinates; feature maps are (h, w, c)
and pooled outputs (R, ph, pw, c), the JAX layouts.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "box_area",
    "iou_matrix",
    "nms",
    "roi_align",
    "roi_align_pyramid",
    "encode_boxes",
    "decode_boxes",
    "clip_boxes",
    "roi_pool_max",
    "roi_crop",
    "BBOX_XFORM_CLIP",
]


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) × (M, 4) → (N, M) IoU."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_outputs: int = 100, score_threshold: float = -float("inf")):
    """Greedy NMS with a static output size.

    Returns (indices, valid): (max_outputs,) int64 indices into `boxes`,
    padded with -1, and a boolean validity mask. Each step picks the first
    highest-scoring live box (argmax takes the first maximum, as
    `jnp.argmax` does) and suppresses every box whose IoU with it exceeds
    the threshold, itself included. The loop never reads a value back to
    the host: the pick stays a one-element tensor (indexing with a 0-d
    tensor would be an implicit `.item()`)."""
    n = boxes.shape[0]
    dev = boxes.device
    suppress = iou_matrix(boxes, boxes) > iou_threshold
    alive = scores > score_threshold
    ar = torch.arange(n, device=dev)
    neg_inf = torch.full((), -float("inf"), dtype=scores.dtype, device=dev)
    minus_one = torch.full((1,), -1, dtype=torch.long, device=dev)
    idxs, oks = [], []
    for _ in range(max_outputs):
        masked = torch.where(alive, scores, neg_inf)
        best = torch.argmax(masked).view(1)
        ok = masked.amax().view(1) > neg_inf
        alive = alive & ~suppress.index_select(0, best)[0] & (ar != best)
        idxs.append(torch.where(ok, best, minus_one))
        oks.append(ok)
    return torch.cat(idxs), torch.cat(oks)


def _sample_grid(x1, y1, bin_w, bin_h, ph: int, pw: int, s: int):
    """Sample coordinates (R, ph, s, pw, s) of an s × s grid in each bin:
    y1 + (i + (k + 0.5)/s)·bin_h, and likewise in x."""
    dt, dev = x1.dtype, x1.device
    ks = (torch.arange(s, dtype=dt, device=dev) + 0.5) / s
    iy = y1[:, None, None] + (torch.arange(ph, dtype=dt, device=dev)[None, :, None]
                              + ks[None, None, :]) * bin_h[:, None, None]
    ix = x1[:, None, None] + (torch.arange(pw, dtype=dt, device=dev)[None, :, None]
                              + ks[None, None, :]) * bin_w[:, None, None]
    yy = iy[:, :, :, None, None]
    xx = ix[:, None, None, :, :]
    return torch.broadcast_tensors(yy, xx)


def _bilinear_weights(yy, xx):
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    return y0, x0, ((1 - wy1) * (1 - wx1), (1 - wy1) * wx1, wy1 * (1 - wx1), wy1 * wx1)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size=(7, 7),
              spatial_scale: float = 1.0, sampling_ratio: int = 2) -> torch.Tensor:
    """Bilinear ROI-Align of an (h, w, c) map: (R, ph, pw, c), the mean of
    sampling_ratio² bilinear samples a bin (Caffe2-aligned sample grid,
    the JAX package's clipping). Differentiable in features and boxes."""
    h, w, _ = features.shape
    ph, pw = output_size
    scaled = boxes * spatial_scale
    x1, y1, x2, y2 = scaled.unbind(1)
    bin_w = (x2 - x1).clamp_min(1.0) / pw
    bin_h = (y2 - y1).clamp_min(1.0) / ph
    yy, xx = _sample_grid(x1, y1, bin_w, bin_h, ph, pw, sampling_ratio)
    y0, x0, (w00, w01, w10, w11) = _bilinear_weights(yy, xx)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    inb = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
    val = (features[y0i, x0i] * w00[..., None] + features[y0i, x1i] * w01[..., None]
           + features[y1i, x0i] * w10[..., None] + features[y1i, x1i] * w11[..., None])
    samples = torch.where(inb[..., None], val, torch.zeros((), dtype=val.dtype, device=val.device))
    return samples.mean(dim=(2, 4))  # (R, ph, s, pw, s, c) → (R, ph, pw, c)


@lru_cache(maxsize=16)
def _level_tables(shapes, strides, device: str):
    """Per pyramid level: 1/stride (float32), height, width and the row
    offset into the flattened buffer, on `device`, built once per
    (shapes, strides, device) so that no call copies from the host."""
    Hs = np.asarray([h for h, _ in shapes], np.int64)
    Ws = np.asarray([w for _, w in shapes], np.int64)
    offs = np.concatenate([[0], np.cumsum(Hs * Ws)])[:-1]
    inv = 1.0 / np.asarray(strides, np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (inv, Hs, Ws, offs))


def roi_align_pyramid(feats, boxes: torch.Tensor, levels: torch.Tensor, strides,
                      output_size=(7, 7), sampling_ratio: int = 2) -> torch.Tensor:
    """ROI-Align against a feature pyramid in one pass: the (Hᵢ, Wᵢ, C)
    maps are flattened into one (ΣHᵢWᵢ, C) row buffer and each box samples
    its level (`levels`, in [0, len(feats))) at that level's scale, with
    per-level row offsets. (R, ph, pw, C); per box the semantics of
    `roi_align` at its level."""
    C = feats[0].shape[-1]
    dev, dt = boxes.device, boxes.dtype
    shapes = tuple((int(f.shape[0]), int(f.shape[1])) for f in feats)
    tables = _level_tables(shapes, tuple(strides), str(dev))
    flat = torch.cat([f.reshape(-1, C) for f in feats], dim=0)
    inv, Hs_t, Ws_t, o_r = (t[levels] for t in tables)

    ph, pw = output_size
    scaled = boxes * inv[:, None].to(dt)
    x1, y1, x2, y2 = scaled.unbind(1)
    bin_w = (x2 - x1).clamp_min(1.0) / pw
    bin_h = (y2 - y1).clamp_min(1.0) / ph
    yy, xx = _sample_grid(x1, y1, bin_w, bin_h, ph, pw, sampling_ratio)
    shape5 = (-1, 1, 1, 1, 1)
    hh, ww = Hs_t.view(shape5), Ws_t.view(shape5)
    oo = o_r.view(shape5)
    y0, x0, (w00, w01, w10, w11) = _bilinear_weights(yy, xx)
    y0i = torch.minimum(y0.long().clamp_min(0), hh - 1)
    y1i = torch.minimum(y0i + 1, hh - 1)
    x0i = torch.minimum(x0.long().clamp_min(0), ww - 1)
    x1i = torch.minimum(x0i + 1, ww - 1)
    inb = (yy >= -1) & (yy <= hh.to(dt)) & (xx >= -1) & (xx <= ww.to(dt))
    val = (flat[oo + y0i * ww + x0i] * w00[..., None] + flat[oo + y0i * ww + x1i] * w01[..., None]
           + flat[oo + y1i * ww + x0i] * w10[..., None] + flat[oo + y1i * ww + x1i] * w11[..., None])
    samples = torch.where(inb[..., None], val, torch.zeros((), dtype=val.dtype, device=val.device))
    return samples.mean(dim=(2, 4))


# --- Detectron-style box regression targets ------------------------------

BBOX_XFORM_CLIP = 4.135  # log(1000/16), the reference's clamp


def _centres(boxes: torch.Tensor):
    bw = boxes[:, 2] - boxes[:, 0] + 1.0
    bh = boxes[:, 3] - boxes[:, 1] + 1.0
    return bw, bh, boxes[:, 0] + 0.5 * bw, boxes[:, 1] + 0.5 * bh


def encode_boxes(boxes: torch.Tensor, gt: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)):
    """(dx, dy, dw, dh) regression targets (`lib/utils/boxes.py` semantics)."""
    wx, wy, ww, wh = weights
    bw, bh, bx, by = _centres(boxes)
    gw, gh, gx, gy = _centres(gt)
    return torch.stack([wx * (gx - bx) / bw, wy * (gy - by) / bh,
                        ww * torch.log(gw / bw), wh * torch.log(gh / bh)], dim=1)


def decode_boxes(boxes: torch.Tensor, deltas: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)):
    """Apply regression deltas to anchors or proposals (log-size deltas
    clamped at `BBOX_XFORM_CLIP`)."""
    wx, wy, ww, wh = weights
    bw, bh, bx, by = _centres(boxes)
    dx, dy = deltas[:, 0] / wx, deltas[:, 1] / wy
    dw = (deltas[:, 2] / ww).clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    dh = (deltas[:, 3] / wh).clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    cx, cy = dx * bw + bx, dy * bh + by
    nw, nh = torch.exp(dw) * bw, torch.exp(dh) * bh
    return torch.stack([cx - 0.5 * nw, cy - 0.5 * nh, cx + 0.5 * nw - 1.0, cy + 0.5 * nh - 1.0],
                       dim=1)


def clip_boxes(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack([boxes[:, 0].clamp(0, w - 1), boxes[:, 1].clamp(0, h - 1),
                        boxes[:, 2].clamp(0, w - 1), boxes[:, 3].clamp(0, h - 1)], dim=1)


def roi_pool_max(features: torch.Tensor, boxes: torch.Tensor, output_size=(7, 7),
                 spatial_scale: float = 1.0, samples: int = 4) -> torch.Tensor:
    """Max ROI pooling: the max over a dense grid of nearest-cell samples
    in each bin, (R, ph, pw, c)."""
    h, w, _ = features.shape
    ph, pw = output_size
    scaled = boxes * spatial_scale
    x1, y1 = scaled[:, 0], scaled[:, 1]
    bin_w = (scaled[:, 2] - x1).clamp_min(1.0) / pw
    bin_h = (scaled[:, 3] - y1).clamp_min(1.0) / ph
    yy, xx = _sample_grid(x1, y1, bin_w, bin_h, ph, pw, samples)
    y0 = torch.floor(yy).long().clamp(0, h - 1)
    x0 = torch.floor(xx).long().clamp(0, w - 1)
    return features[y0, x0].amax(dim=(2, 4))


def roi_crop(features: torch.Tensor, boxes: torch.Tensor, output_size=(7, 7),
             spatial_scale: float = 1.0) -> torch.Tensor:
    """STN-style bilinear ROI crop: one exact bilinear tap at the centre of
    each of the (ph × pw) cells spanning a box, (R, ph, pw, c)."""
    h, w, _ = features.shape
    ph, pw = output_size
    dt, dev = boxes.dtype, boxes.device
    scaled = boxes * spatial_scale
    x1, y1, x2, y2 = scaled.unbind(1)
    ys = y1[:, None] + (torch.arange(ph, dtype=dt, device=dev) + 0.5) / ph * (y2 - y1).clamp_min(1.0)[:, None]
    xs = x1[:, None] + (torch.arange(pw, dtype=dt, device=dev) + 0.5) / pw * (x2 - x1).clamp_min(1.0)[:, None]
    yy, xx = torch.broadcast_tensors(ys[:, :, None], xs[:, None, :])  # (R, ph, pw)
    y0 = torch.floor(yy).long().clamp(0, h - 1)
    x0 = torch.floor(xx).long().clamp(0, w - 1)
    y1i = (y0 + 1).clamp(0, h - 1)
    x1i = (x0 + 1).clamp(0, w - 1)
    wy = yy - torch.floor(yy)
    wx = xx - torch.floor(xx)
    return (features[y0, x0] * ((1 - wy) * (1 - wx))[..., None]
            + features[y0, x1i] * ((1 - wy) * wx)[..., None]
            + features[y1i, x0] * (wy * (1 - wx))[..., None]
            + features[y1i, x1i] * (wy * wx)[..., None])
