"""Test-time augmentation for detection: hflip and multi-scale views
(counterpart of the JAX package's `models/detection/tta.py`).

Every view runs the detector at its own size; the detections of all views
are mapped back to the original frame, concatenated into one fixed-size
set and merged by one class-aware NMS into a padded list of
`num_detections` (the union + NMS merge of the reference's
`im_detect_bbox_aug`). A scaled view is resized by antialiased bilinear
interpolation, which matches `jax.image.resize(..., "linear")` when
shrinking (plain bilinear does not).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.detection import nms

__all__ = ["hflip_boxes", "detect_augmented"]


def hflip_boxes(boxes: torch.Tensor, width: int) -> torch.Tensor:
    """Boxes detected on a horizontally flipped image, in the original frame."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([width - x2, y1, width - x1, y2], dim=-1)


def _merged_nms(num_det: int, boxes, scores, extent: float, nms_thresh: float,
                score_thresh: float, classes):
    """Class-aware NMS: each class's boxes offset into a disjoint slab
    (stride above the image extent), so one NMS suppresses within classes."""
    offset = classes.to(boxes.dtype)[:, None] * (extent + 1.0)
    keep, valid = nms(boxes + offset, scores, nms_thresh, num_det, score_threshold=score_thresh)
    safe = keep.clamp_min(0)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return (torch.where(valid[:, None], boxes[safe], zero), torch.where(valid, classes[safe], 0),
            torch.where(valid, scores[safe], zero), valid)


def _resize(image: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """(h, w, c) → (hs, ws, c), bilinear at half-pixel centres, antialiased."""
    x = image.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(hs, ws), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


@torch.no_grad()
def detect_augmented(model, image: torch.Tensor, hflip: bool = True, scales=(),
                     nms_thresh: float = 0.5, score_thresh: float = 0.05, infer_fn=None) -> dict:
    """Detection over augmented views, merged.

    Args:
      model: a `MaskRCNN` (or a module with its inference outputs).
      image: (h, w, 3) float image on the model's device.
      hflip: include the horizontally flipped view.
      scales: extra resize factors, e.g. (0.75, 1.25).
      infer_fn: optional image → detections callable; default
        `model(image, train=False)`.

    Returns dict(boxes, classes, scores, valid), padded to the model's
    detection count and merged from all views by class-aware NMS.
    """
    h, w = image.shape[:2]
    infer = infer_fn if infer_fn is not None else (lambda im: model(im, train=False))
    views = [(infer(image), lambda b: b)]
    if hflip:
        views.append((infer(image.flip(1)), lambda b: hflip_boxes(b, w)))
    for s in scales:
        hs, ws = int(round(h * s)), int(round(w * s))
        out = infer(_resize(image, hs, ws))
        factor = torch.tensor([w / ws, h / hs, w / ws, h / hs], dtype=torch.float64,
                              device=image.device)
        views.append((out, lambda b, f=factor: b * f.to(b.dtype)))

    boxes = torch.cat([unmap(o["boxes"]) for o, unmap in views])
    classes = torch.cat([o["classes"] for o, _ in views])
    # invalid slots carry score 0 and fall under the score threshold
    scores = torch.cat([torch.where(o["valid"], o["scores"], torch.zeros_like(o["scores"]))
                        for o, _ in views])
    num_det = views[0][0]["boxes"].shape[0]
    fb, fc, fs, valid = _merged_nms(num_det, boxes, scores, float(max(h, w)), nms_thresh,
                                    max(score_thresh, 1e-6), classes)
    return {"boxes": fb, "classes": fc, "scores": fs, "valid": valid}
