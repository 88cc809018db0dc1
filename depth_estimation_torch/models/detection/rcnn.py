"""Two-stage detector: RPN → proposals → ROI heads (box, mask, keypoint)
(counterpart of the JAX package's `models/detection/rcnn.py`).

Every stage keeps the JAX package's fixed shapes: top-K proposals by NMS
with a fixed trip count, a static detection count, ROI-Align from the
pyramid level of each box. Three details carry the JAX semantics:

- every ranking is a stable sort (`torch.argsort(..., stable=True)`), as
  `jnp.argsort` is: at `score_thresh=-1` invalid proposals tie at score 0;
- `BoxHead` flattens its (R, 7, 7, c) ROI features in the JAX order
  (ph, pw, c), so its first `Linear` takes the flax `Dense` kernel as it is
  (transposed);
- the proposals are not detached: the training loss differentiates
  through them into the RPN deltas, as the JAX loss does.

`MaskRCNN.forward` chains three stages that are methods of their own, so
that a caller can feed each stage a given input: `features` (ResNet+FPN),
`rpn` (the RPN head and the proposal layer, whose choice of anchors is
`select_proposals`) and `roi_heads` (box head, per-class detections, mask
and keypoint heads on given proposals).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.detection import clip_boxes, decode_boxes, nms, roi_align_pyramid
from ...utils.device import resolve_device
from .anchors import pyramid_anchors
from ..features import seeded_init
from .backbone import GN_EPS, ResNetFPN

__all__ = [
    "RPNHead",
    "BoxHead",
    "MaskHead",
    "KeypointHead",
    "MaskRCNN",
    "fpn_level_for_boxes",
    "pyramid_roi_align",
    "perclass_detections",
    "keypoint_loss",
    "FPN_STRIDES",
    "FPN_SCALES",
]

FPN_STRIDES = (4, 8, 16, 32, 64)
FPN_SCALES = (32, 64, 128, 256, 512)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class RPNHead(nn.Module):
    """Shared 3×3 conv → (objectness, deltas) per level; each level's
    outputs flattened in (row, column, anchor) order."""

    def __init__(self, num_anchors: int = 3, dim: int = 256):
        super().__init__()
        self.rpn_conv = nn.Conv2d(dim, dim, 3, padding=1)
        self.rpn_cls = nn.Conv2d(dim, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(dim, num_anchors * 4, 1)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            y = F.relu(self.rpn_conv(f))
            logits.append(_nhwc(self.rpn_cls(y)).reshape(-1))
            deltas.append(_nhwc(self.rpn_reg(y)).reshape(-1, 4))
        return torch.cat(logits), torch.cat(deltas)


class BoxHead(nn.Module):
    """2-fc box head on (R, ph, pw, c) ROI features, flattened as (ph, pw, c)."""

    def __init__(self, in_dim: int, num_classes: int = 81, dim: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.Dense_0 = nn.Linear(in_dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self.Dense_2 = nn.Linear(dim, num_classes)
        self.Dense_3 = nn.Linear(dim, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor):
        R = roi_feats.shape[0]
        y = F.relu(self.Dense_0(roi_feats.reshape(R, -1)))
        y = F.relu(self.Dense_1(y))
        return self.Dense_2(y), self.Dense_3(y).reshape(R, self.num_classes, 4)


def _conv_gn_stack(module: nn.Module, cin: int, dim: int, groups: int) -> None:
    for k in range(4):
        module.add_module(f"Conv_{k}", nn.Conv2d(cin if k == 0 else dim, dim, 3, padding=1))
        module.add_module(f"GroupNorm_{k}", nn.GroupNorm(groups, dim, eps=GN_EPS))


def _run_conv_gn_stack(module: nn.Module, y: torch.Tensor) -> torch.Tensor:
    for k in range(4):
        y = F.relu(getattr(module, f"GroupNorm_{k}")(getattr(module, f"Conv_{k}")(y)))
    return y


class MaskHead(nn.Module):
    """4 conv+GN layers, a 2× deconvolution and a 1×1 class conv:
    (R, ph, pw, c) → (R, 2ph, 2pw, K)."""

    def __init__(self, in_dim: int, num_classes: int = 81, dim: int = 256):
        super().__init__()
        _conv_gn_stack(self, in_dim, dim, 32)
        self.ConvTranspose_0 = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.Conv_4 = nn.Conv2d(dim, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        y = _run_conv_gn_stack(self, roi_feats.permute(0, 3, 1, 2))
        y = F.relu(self.ConvTranspose_0(y))
        return _nhwc(self.Conv_4(y))


class KeypointHead(nn.Module):
    """Keypoint heatmap head: 4 conv+GN layers and two 2× deconvolutions,
    (R, ph, pw, c) → (R, 4ph, 4pw, Kp) logits."""

    def __init__(self, in_dim: int, num_keypoints: int = 17, dim: int = 256):
        super().__init__()
        _conv_gn_stack(self, in_dim, dim, max(1, min(32, dim // 8)))
        self.ConvTranspose_0 = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.ConvTranspose_1 = nn.ConvTranspose2d(dim, num_keypoints, 2, stride=2)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        y = _run_conv_gn_stack(self, roi_feats.permute(0, 3, 1, 2))
        y = F.relu(self.ConvTranspose_0(y))
        return _nhwc(self.ConvTranspose_1(y))


def fpn_level_for_boxes(boxes: torch.Tensor, k0: int = 4, k_min: int = 2, k_max: int = 5):
    """log2 level assignment: k = floor(k0 + log2(sqrt(area)/224)), clipped
    to [k_min, k_max]."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp_min(1.0) * (boxes[:, 3] - boxes[:, 1]).clamp_min(1.0)
    k = torch.floor(k0 + torch.log2(torch.sqrt(area) / 224.0 + 1e-9))
    return k.clamp(k_min, k_max).long()


def pyramid_roi_align(feats, boxes: torch.Tensor, output_size=(7, 7)) -> torch.Tensor:
    """ROI-Align from the FPN level each box maps to (P2..P5 of NCHW
    `feats`), (R, ph, pw, c)."""
    levels = fpn_level_for_boxes(boxes.detach())
    maps = [f[0].permute(1, 2, 0) for f in feats[:4]]
    return roi_align_pyramid(maps, boxes, levels - 2, FPN_STRIDES[:4], output_size)


def perclass_detections(probs: torch.Tensor, cls_deltas: torch.Tensor, proposals: torch.Tensor,
                        prop_valid: torch.Tensor, h: int, w: int, num_detections: int,
                        nms_thresh: float = 0.5, score_thresh: float = 0.05):
    """Per-class detection layer: every (proposal, foreground class) pair is
    a candidate with its own class-specific refined box; the top 4·D by
    score go through one class-aware NMS (each class offset into its own
    coordinate slab). Returns (boxes (D, 4), classes (D,), scores (D,),
    valid (D,))."""
    P, K = probs.shape
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    cand_scores = torch.where(prop_valid[:, None], probs[:, 1:], zero).reshape(-1)
    cand_boxes = clip_boxes(decode_boxes(proposals.repeat_interleave(K - 1, dim=0),
                                         cls_deltas[:, 1:].reshape(-1, 4)), h, w)
    cand_cls = torch.arange(1, K, device=probs.device).repeat(P)
    M = min(4 * num_detections, P * (K - 1))
    topc = torch.argsort(-cand_scores, stable=True)[:M]
    slab = cand_cls[topc].to(cand_boxes.dtype)[:, None] * (float(max(h, w)) + 1.0)
    keep, valid = nms(cand_boxes[topc] + slab, cand_scores[topc], nms_thresh, num_detections,
                      score_threshold=score_thresh)
    safe = topc[keep.clamp_min(0)]
    return (torch.where(valid[:, None], cand_boxes[safe], zero),
            torch.where(valid, cand_cls[safe], 0),
            torch.where(valid, cand_scores[safe], zero),
            valid)


class MaskRCNN(nn.Module):
    """End-to-end two-stage detector. Image (h, w, 3) → dict with the JAX
    package's keys: boxes, classes, scores, valid, masks (D, 28, 28; None
    when training), proposals, proposal_valid, rpn_scores, rpn_logits,
    rpn_deltas, anchors, cls_scores, cls_deltas, mask_logits, and with
    `num_keypoints > 0` kp_logits (+ keypoints at inference).

    Weights are random, N(0, 1/fan_in) from `generator` (seeded 0 if None),
    or loaded by `utils.weights.load_jax_params` / `load_state_dict`. The
    module is built on `device` (None: the GPU)."""

    def __init__(self, num_classes: int = 81, blocks: Sequence[int] = (3, 4, 6, 3),
                 fpn_dim: int = 256, num_proposals: int = 256, num_detections: int = 64,
                 rpn_nms_thresh: float = 0.7, det_nms_thresh: float = 0.5,
                 score_thresh: float = 0.05, num_keypoints: int = 0, backbone_norm: str = "gn",
                 stride_1x1: bool = False, base_width: int = 64,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.num_proposals = num_proposals
        self.num_detections = num_detections
        self.rpn_nms_thresh = rpn_nms_thresh
        self.det_nms_thresh = det_nms_thresh
        self.score_thresh = score_thresh
        self.num_keypoints = num_keypoints
        self.ResNetFPN_0 = ResNetFPN(blocks, fpn_dim, norm=backbone_norm, stride_1x1=stride_1x1,
                                     base_width=base_width)
        self.RPNHead_0 = RPNHead(dim=fpn_dim)
        self.BoxHead_0 = BoxHead(7 * 7 * fpn_dim, num_classes)
        self.MaskHead_0 = MaskHead(fpn_dim, num_classes)
        if num_keypoints > 0:
            self.KeypointHead_0 = KeypointHead(fpn_dim, num_keypoints, dim=fpn_dim)
        seeded_init(self, generator)
        self.to(dev)

    def features(self, image: torch.Tensor) -> list[torch.Tensor]:
        """(h, w, 3) image → [P2, P3, P4, P5, P6], each (1, c, h_l, w_l)."""
        dt = self.ResNetFPN_0.ResNet_0.Conv_0.weight.dtype
        return self.ResNetFPN_0(image.to(dt).permute(2, 0, 1)[None])

    def rpn(self, feats, h: int, w: int) -> dict:
        """RPN head and proposal layer: decode, clip, `select_proposals`,
        the proposals (zeros where invalid) with their gradient to the
        deltas."""
        rpn_logits, rpn_deltas = self.RPNHead_0(feats)
        shapes = [tuple(f.shape[-2:]) for f in feats]
        anchors = pyramid_anchors(shapes, FPN_STRIDES, FPN_SCALES, device=rpn_deltas.device)
        boxes = clip_boxes(decode_boxes(anchors, rpn_deltas), h, w)
        scores = torch.sigmoid(rpn_logits)
        prop_idx, valid = self.select_proposals(boxes, scores)
        proposals = torch.where(valid[:, None], boxes[prop_idx],
                                torch.zeros((), dtype=boxes.dtype, device=boxes.device))
        return {"proposals": proposals, "proposal_valid": valid, "rpn_scores": scores,
                "rpn_logits": rpn_logits, "rpn_deltas": rpn_deltas, "anchors": anchors}

    def select_proposals(self, boxes: torch.Tensor, scores: torch.Tensor):
        """The proposals among the decoded anchor boxes: the stable top 4·P
        by objectness, then NMS to P. Returns (anchor index of each
        proposal (P,), valid (P,)); the indices carry no gradient."""
        top = torch.argsort(-scores, stable=True)[:4 * self.num_proposals]
        keep, valid = nms(boxes[top], scores[top], self.rpn_nms_thresh, self.num_proposals)
        return top[keep.clamp_min(0)], valid

    def roi_heads(self, feats, proposals: torch.Tensor, valid: torch.Tensor, h: int, w: int,
                  train: bool = False) -> dict:
        """Box head, per-class detections and the mask (and keypoint) head:
        on the proposals when training, on the detections at inference."""
        roi_feats = pyramid_roi_align(feats, proposals, (7, 7))
        cls_scores, cls_deltas = self.BoxHead_0(roi_feats)
        probs = torch.softmax(cls_scores, dim=-1)
        boxes, classes, scores, valid2 = perclass_detections(
            probs, cls_deltas, proposals, valid, h, w, self.num_detections,
            self.det_nms_thresh, self.score_thresh)
        mask_boxes = proposals if train else boxes
        mask_feats = pyramid_roi_align(feats, mask_boxes, (14, 14))
        mask_logits = self.MaskHead_0(mask_feats)  # (·, 28, 28, K)
        masks = None
        if not train:
            masks = torch.sigmoid(torch.gather(
                mask_logits, -1, classes[:, None, None, None].expand(*mask_logits.shape[:3], 1))[..., 0])
        out = {"boxes": boxes, "classes": classes, "scores": scores, "valid": valid2,
               "masks": masks, "cls_scores": cls_scores, "cls_deltas": cls_deltas,
               "mask_logits": mask_logits}
        if self.num_keypoints > 0:
            kp_logits = self.KeypointHead_0(mask_feats)  # (·, 56, 56, Kp)
            out["kp_logits"] = kp_logits
            if not train:
                R, m, _, Kp = kp_logits.shape
                bins = torch.argmax(kp_logits.reshape(R, m * m, Kp), dim=1)  # (R, Kp)
                # bin centres in float32, as the JAX package computes them
                bx = (bins % m).to(torch.float32) + 0.5
                by = torch.div(bins, m, rounding_mode="floor").to(torch.float32) + 0.5
                x1, y1 = mask_boxes[:, 0], mask_boxes[:, 1]
                bw = (mask_boxes[:, 2] - x1).clamp_min(1.0)
                bh = (mask_boxes[:, 3] - y1).clamp_min(1.0)
                out["keypoints"] = torch.stack([x1[:, None] + bx / m * bw[:, None],
                                                y1[:, None] + by / m * bh[:, None]], dim=-1)
        return out

    def forward(self, image: torch.Tensor, train: bool = False, gt_boxes=None, gt_valid=None):
        h, w = image.shape[:2]
        feats = self.features(image)
        out = self.rpn(feats, h, w)
        proposals, valid = out["proposals"], out["proposal_valid"]
        if train and gt_boxes is not None:
            # GT boxes replace the lowest-ranked proposal slots (Detectron's
            # TRAIN.PROPOSAL_APPEND_GT), so the ROI heads see foreground
            # samples from the first step
            G = gt_boxes.shape[0]
            proposals = torch.cat([proposals[:-G], gt_boxes.to(proposals.dtype)])
            valid = torch.cat([valid[:-G], gt_valid.to(torch.bool)])
            out.update(proposals=proposals, proposal_valid=valid)
        out.update(self.roi_heads(feats, proposals, valid, h, w, train))
        return out


def keypoint_loss(kp_logits: torch.Tensor, tgt_xy: torch.Tensor, tgt_visible: torch.Tensor,
                  fg: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy over the flattened heatmap at the target bin.

    kp_logits (R, m, m, K); tgt_xy (R, K, 2) bin coordinates in [0, m);
    tgt_visible (R, K) bool; fg (R,) foreground mask."""
    R, m, _, K = kp_logits.shape
    logp = torch.log_softmax(kp_logits.reshape(R, m * m, K), dim=1)
    bins = tgt_xy[..., 1].long() * m + tgt_xy[..., 0].long()
    bins = bins.clamp(0, m * m - 1)
    picked = torch.gather(logp, 1, bins[:, None, :])[:, 0, :]  # (R, K)
    w = tgt_visible.to(picked.dtype) * fg[:, None].to(picked.dtype)
    return -(picked * w).sum() / w.sum().clamp_min(1.0)
