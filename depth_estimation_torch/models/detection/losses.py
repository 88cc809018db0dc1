"""Detection training losses and target assignment, fixed-shape
(counterpart of the JAX package's `models/detection/losses.py`).

The five-loss family: RPN objectness (class-balanced BCE), RPN box
(smooth-L1 on positives), ROI classification (fg/bg-balanced softmax CE),
ROI box regression (per-class smooth-L1) and the mask BCE on the target
class's slice; plus the ROI-frame mask and keypoint targets. Labels are
{-1 ignore, 0 negative, 1.. positive}; sampling is weighted masking.
"""
from __future__ import annotations

import torch

from ...ops.detection import encode_boxes, iou_matrix, roi_align

__all__ = [
    "smooth_l1",
    "match_anchors",
    "rpn_losses",
    "roi_losses",
    "mask_loss",
    "roi_mask_targets",
    "keypoint_targets",
]


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x ** 2 / beta, ax - 0.5 * beta)


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _best_match(iou: torch.Tensor, gt_valid: torch.Tensor):
    """Per row, the first GT of highest IoU among the valid ones and that IoU."""
    iou = torch.where(gt_valid[None, :], iou, torch.full((), -1.0, dtype=iou.dtype,
                                                         device=iou.device))
    best_iou, _ = iou.max(dim=1)
    return iou, torch.argmax(iou, dim=1), best_iou


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  pos_iou: float = 0.7, neg_iou: float = 0.3):
    """IoU matching: (labels (A,) in {1, 0, -1}, matched GT index (A,)).

    IoU ≥ pos_iou is positive, < neg_iou negative, else ignored; the best
    anchor of every valid GT is positive too. The JAX package scatters that
    with duplicate indices (every padded GT's best anchor is 0), which
    leaves anchor 0 undefined when a valid GT's best anchor is 0 as well;
    here an anchor is forced positive exactly when a valid GT picks it,
    which equals the JAX result wherever that is defined."""
    iou, best_gt, best_iou = _best_match(iou_matrix(anchors, gt_boxes), gt_valid)
    one, zero, ign = (torch.full((), v, dtype=torch.long, device=iou.device) for v in (1, 0, -1))
    labels = torch.where(best_iou >= pos_iou, one, torch.where(best_iou < neg_iou, zero, ign))
    best_anchor = torch.argmax(iou, dim=0)  # (G,)
    forced = torch.zeros_like(labels).scatter_reduce(0, best_anchor, gt_valid.long(), "amax")
    return torch.where(forced > 0, one, labels), best_gt


def rpn_losses(rpn_logits, rpn_deltas, anchors, gt_boxes, gt_valid):
    """(objectness BCE, box smooth-L1): the BCE is the mean over positives
    and the mean over negatives weighted 1:1 (the static-shape form of the
    reference's balanced anchor sampling); the box loss is the mean over
    positives."""
    labels, matched = match_anchors(anchors, gt_boxes, gt_valid)
    pos, neg = labels == 1, labels == 0
    bce = _bce_with_logits(rpn_logits, pos.to(rpn_logits.dtype))
    npos, nneg = pos.sum().clamp_min(1), neg.sum().clamp_min(1)
    cls_loss = 0.5 * (bce * pos).sum() / npos + 0.5 * (bce * neg).sum() / nneg
    reg_tgt = encode_boxes(anchors, gt_boxes[matched])
    reg = smooth_l1(rpn_deltas - reg_tgt).sum(-1)
    return cls_loss, (reg * pos).sum() / npos


def roi_losses(cls_scores, cls_deltas, proposals, prop_valid, gt_boxes, gt_classes, gt_valid,
               fg_iou: float = 0.5):
    """(classification CE, per-class box smooth-L1, target classes, matched
    GT, foreground mask). The CE mixes the fg and bg means at the
    reference's FG_FRACTION 0.25."""
    _, best_gt, best_iou = _best_match(iou_matrix(proposals, gt_boxes), gt_valid)
    fg = (best_iou >= fg_iou) & prop_valid
    tgt_cls = torch.where(fg, gt_classes[best_gt].long(), 0)
    ce = -torch.gather(torch.log_softmax(cls_scores, dim=-1), 1, tgt_cls[:, None])[:, 0]
    bg = prop_valid & ~fg
    cls_loss = (0.25 * (ce * fg).sum() / fg.sum().clamp_min(1)
                + 0.75 * (ce * bg).sum() / bg.sum().clamp_min(1))
    reg_tgt = encode_boxes(proposals, gt_boxes[best_gt])
    deltas_at_cls = torch.gather(cls_deltas, 1, tgt_cls[:, None, None].expand(-1, 1, 4))[:, 0]
    reg = smooth_l1(deltas_at_cls - reg_tgt).sum(-1)
    reg_loss = (reg * fg).sum() / fg.sum().clamp_min(1)
    return cls_loss, reg_loss, tgt_cls, best_gt, fg


def roi_mask_targets(gt_masks: torch.Tensor, best_gt: torch.Tensor, proposals: torch.Tensor,
                     size=(28, 28)) -> torch.Tensor:
    """ROI-frame mask targets (R, m, m) in {0, 1}: the G instance masks as
    channels of one (h, w, G) map, ROI-aligned at every proposal in one
    call, the matched channel taken and binarised at 0.5."""
    stacked = gt_masks.to(torch.float32).permute(1, 2, 0)
    crops = roi_align(stacked, proposals, size, spatial_scale=1.0)  # (R, m, m, G)
    idx = best_gt[:, None, None, None].expand(*crops.shape[:3], 1)
    return (torch.gather(crops, -1, idx)[..., 0] >= 0.5).to(torch.float32)


def keypoint_targets(gt_keypoints, gt_kp_visible, best_gt, proposals, heatmap_size: int = 56):
    """Each matched GT keypoint in its proposal's heatmap bin frame: (bin
    coordinates (R, K, 2) floored, visible (R, K) and inside the ROI)."""
    m = heatmap_size
    kps, vis = gt_keypoints[best_gt], gt_kp_visible[best_gt]
    x1, y1 = proposals[:, 0], proposals[:, 1]
    bw = (proposals[:, 2] - x1).clamp_min(1.0)
    bh = (proposals[:, 3] - y1).clamp_min(1.0)
    bx = (kps[..., 0] - x1[:, None]) / bw[:, None] * m
    by = (kps[..., 1] - y1[:, None]) / bh[:, None] * m
    inb = (bx >= 0) & (bx < m) & (by >= 0) & (by < m)
    return torch.stack([torch.floor(bx), torch.floor(by)], dim=-1), vis & inb


def mask_loss(mask_logits, tgt_cls, tgt_masks, fg):
    """Per-pixel BCE on the target class's slice, averaged per ROI, mean
    over foreground ROIs."""
    idx = tgt_cls[:, None, None, None].expand(*mask_logits.shape[:3], 1)
    logits = torch.gather(mask_logits, -1, idx)[..., 0]
    per_roi = _bce_with_logits(logits, tgt_masks.to(logits.dtype)).mean(dim=(1, 2))
    return (per_roi * fg).sum() / fg.sum().clamp_min(1)
