"""Visualization: draw detections/masks onto images, save panels
(the port's own copy of the JAX package's `utils/visualize.py`).

Capability of `Mask_RCNN/mrcnn/visualize.py` (`display_instances`) without
matplotlib dependency at inference time — pure numpy rasterization → PIL.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "draw_detections",
    "paste_roi_masks",
    "color_splash",
    "colorize_labels",
    "save_image",
    "disparity_panel",
]

_PALETTE = np.array(
    [
        [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
        [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
        [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    ],
    np.uint8,
)


def draw_detections(image, boxes, classes=None, scores=None, masks=None,
                    valid=None, thickness: int = 2, mask_alpha: float = 0.4):
    """Rasterize boxes (+optional ROI-frame masks) onto a float [0,1] image.

    boxes: (D, 4) x1,y1,x2,y2; masks: (D, m, m) in ROI frame (resized into
    each box, `unmold_detections` semantics, `mrcnn/model.py:2425-2489`).
    Returns uint8 (h, w, 3).
    """
    out = (np.asarray(image) * 255).astype(np.uint8).copy()
    h, w = out.shape[:2]
    D = len(boxes)
    for i in range(D):
        if valid is not None and not valid[i]:
            continue
        color = _PALETTE[(int(classes[i]) if classes is not None else i) % len(_PALETTE)]
        x1, y1, x2, y2 = [int(round(float(v))) for v in boxes[i]]
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        if x2 <= x1 or y2 <= y1:
            continue
        for t in range(thickness):
            out[np.clip(y1 + t, 0, h - 1), x1:x2] = color
            out[np.clip(y2 - t, 0, h - 1), x1:x2] = color
            out[y1:y2, np.clip(x1 + t, 0, w - 1)] = color
            out[y1:y2, np.clip(x2 - t, 0, w - 1)] = color
        if masks is not None:
            bh, bw = y2 - y1, x2 - x1
            if bh > 0 and bw > 0:
                m = np.asarray(masks[i])
                yi = (np.arange(bh)[:, None] * (m.shape[0] / bh)).astype(int)
                xi = (np.arange(bw)[None, :] * (m.shape[1] / bw)).astype(int)
                mm = m[np.clip(yi, 0, m.shape[0] - 1), np.clip(xi, 0, m.shape[1] - 1)] > 0.5
                region = out[y1:y2, x1:x2]
                region[mm] = (
                    (1 - mask_alpha) * region[mm] + mask_alpha * color
                ).astype(np.uint8)
    return out


def paste_roi_masks(boxes, masks, h, w, valid=None, threshold: float = 0.5):
    """ROI-frame masks → full-frame boolean masks.

    boxes: (D, 4) x1,y1,x2,y2 pixel coords; masks: (D, m, m) in ROI frame.
    Nearest-neighbor resize of each ROI mask into its box (the
    `unmold_detections` paste, `mrcnn/model.py:2425-2489`). Returns
    (D, h, w) bool.
    """
    boxes = np.asarray(boxes)
    masks = np.asarray(masks)
    D = len(boxes)
    full = np.zeros((D, h, w), bool)
    for i in range(D):
        if valid is not None and not valid[i]:
            continue
        x1, y1, x2, y2 = [int(round(float(v))) for v in boxes[i]]
        x1, x2 = np.clip([x1, x2], 0, w)
        y1, y2 = np.clip([y1, y2], 0, h)
        bh, bw = y2 - y1, x2 - x1
        if bh <= 0 or bw <= 0:
            continue
        m = masks[i]
        yi = (np.arange(bh)[:, None] * (m.shape[0] / bh)).astype(int)
        xi = (np.arange(bw)[None, :] * (m.shape[1] / bw)).astype(int)
        full[i, y1:y2, x1:x2] = (
            m[np.clip(yi, 0, m.shape[0] - 1), np.clip(xi, 0, m.shape[1] - 1)]
            > threshold
        )
    return full


def color_splash(image, masks):
    """Gray out everything except the detected instances.

    Capability of the balloon demo (`Mask_RCNN/samples/balloon/balloon.py:
    202-217`): luminance-gray copy of the image, original color kept where
    any instance mask is set. image: float [0,1] (h, w, 3); masks:
    (D, h, w) or (h, w) bool. Returns uint8 (h, w, 3).
    """
    img = np.asarray(image, np.float32)
    masks = np.asarray(masks, bool)
    union = masks.any(0) if masks.ndim == 3 else masks
    lum = img @ np.array([0.299, 0.587, 0.114], np.float32)
    gray = np.repeat(lum[..., None], 3, axis=-1)
    out = np.where(union[..., None], img, gray)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def colorize_labels(labels, num_labels=None):
    """(h, w) int labels → uint8 color map."""
    labels = np.asarray(labels)
    return _PALETTE[labels % len(_PALETTE)]


def save_image(path, array):
    from PIL import Image

    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def disparity_panel(img, unary, refined, gt=None, vmax=None):
    """Side-by-side uint8 panel (the reference's 3-panel Unary/CRF/GT
    eyeball plot, `DenseCrf.ipynb` cell 12) as one image row."""
    panels = []
    arrays = [a for a in (unary, refined, gt) if a is not None]
    if vmax is None:
        vmax = max(float(np.nanmax(np.asarray(a))) for a in arrays) or 1.0
    img8 = (np.asarray(img) * 255).astype(np.uint8)
    panels.append(img8)
    for a in arrays:
        norm = np.clip(np.asarray(a, float) / vmax, 0, 1)
        panels.append((norm[..., None] * np.array([255, 255, 255])).astype(np.uint8))
    return np.concatenate(panels, axis=1)
