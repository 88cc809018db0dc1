"""Detection evaluation: VOC/COCO-style average precision
(the port's own copy of the JAX package's `train/eval_detection.py`,
with `coco_map`'s `sim_key` similarity restricted to the category's GT
columns as well as its predictions).

Capability of the reference's AP utilities (`Mask_RCNN/mrcnn/utils.py:
665-811` `compute_ap`/`compute_recall` and the pycocotools-based
`evaluate_coco`): greedy IoU matching of ranked predictions to GT,
precision/recall curve integration, mAP over IoU thresholds .5:.95.

Host-side numpy (evaluation is not a hot path).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "COCO_KP_SIGMAS",
    "compute_ap",
    "compute_keypoint_ap",
    "compute_map_range",
    "coco_map",
    "match_predictions",
    "mask_mean_iou",
    "oks_matrix",
]

# Per-keypoint falloff constants of the COCO keypoint metric (OKS σ_i for
# the 17 person keypoints: nose, eyes, ears, shoulders, elbows, wrists,
# hips, knees, ankles) — the published constants of the task definition
# (cocodataset.org/#keypoints-eval; `mask-rcnn.pytorch/BENCHMARK.md:231-`
# reports AP under exactly this metric).
COCO_KP_SIGMAS = np.array(
    [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
     0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089]
)


def _iou_matrix_np(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def match_predictions(pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes,
                      iou_threshold=0.5, sim=None):
    """Greedy score-ranked matching. Returns (pred_match, gt_match) index
    arrays (-1 = unmatched), semantics of `mrcnn/utils.py:665-723`.

    `sim`: optional precomputed (P, G) similarity matrix in ORIGINAL pred
    order (e.g. `oks_matrix` for keypoints) replacing box IoU."""
    order = np.argsort(-pred_scores)
    pred_boxes = pred_boxes[order]
    pred_classes = pred_classes[order]
    if sim is not None:
        iou = np.asarray(sim)[order]
    else:
        iou = _iou_matrix_np(pred_boxes, gt_boxes) if len(gt_boxes) else np.zeros((len(pred_boxes), 0))
    pred_match = -np.ones(len(pred_boxes), np.int64)
    gt_match = -np.ones(len(gt_boxes), np.int64)
    for i in range(len(pred_boxes)):
        cand = np.argsort(-iou[i]) if iou.shape[1] else []
        for j in cand:
            if iou[i, j] < iou_threshold:
                break
            if gt_match[j] >= 0 or gt_classes[j] != pred_classes[i]:
                continue
            gt_match[j] = i
            pred_match[i] = j
            break
    return pred_match, gt_match, order


def _ap_from_matches(pred_match, num_gt, interpolation):
    """PR integration from score-ranked match flags.

    interpolation:
      'all'     — all-points interpolated AP (`mrcnn/utils.py:716-757`).
      'coco101' — the COCO definition: mean of the monotone precision
        envelope sampled at the 101 recall thresholds 0.00:0.01:1.00
        (what pycocotools' accumulate computes per category; the
        reference's published numbers are under this definition).
    """
    tp = (pred_match >= 0).astype(np.float64)
    precisions = np.cumsum(tp) / (np.arange(len(tp)) + 1)
    recalls = np.cumsum(tp) / num_gt
    if interpolation == "coco101":
        for i in range(len(precisions) - 2, -1, -1):
            precisions[i] = max(precisions[i], precisions[i + 1])
        rec_thrs = np.linspace(0.0, 1.0, 101)
        inds = np.searchsorted(recalls, rec_thrs, side="left")
        q = np.zeros(101)
        ok = inds < len(precisions)
        q[ok] = precisions[inds[ok]]
        return float(q.mean()), precisions, recalls
    precisions = np.concatenate([[0.0], precisions, [0.0]])
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[1:] != recalls[:-1])[0] + 1
    ap = float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))
    return ap, precisions, recalls


def compute_ap(pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes,
               iou_threshold=0.5, interpolation="all"):
    """AP at one IoU threshold. Returns (AP, precisions, recalls).

    `interpolation='all'` is the Mask-RCNN utils semantics (pooled
    classes, all-points integration); 'coco101' switches the integration
    to the COCO 101-recall-point definition (see `coco_map` for the fully
    COCO-faithful per-category metric)."""
    if len(gt_boxes) == 0:
        return (1.0 if len(pred_boxes) == 0 else 0.0), None, None
    if len(pred_boxes) == 0:
        return 0.0, None, None
    pred_match, _, _ = match_predictions(
        pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes, iou_threshold
    )
    return _ap_from_matches(pred_match, len(gt_boxes), interpolation)


def _crop_mask_np(mask, box, size):
    """Nearest-neighbor crop of a full-image {0,1} mask to `box`, resized
    to (size, size) — the host-side counterpart of
    `losses.roi_mask_targets` for evaluation."""
    h, w = mask.shape
    x1, y1, x2, y2 = box
    ys = y1 + (np.arange(size) + 0.5) / size * max(y2 - y1, 1.0)
    xs = x1 + (np.arange(size) + 0.5) / size * max(x2 - x1, 1.0)
    yi = np.clip(ys.astype(int), 0, h - 1)
    xi = np.clip(xs.astype(int), 0, w - 1)
    return mask[yi[:, None], xi[None, :]] > 0.5


def mask_mean_iou(pred_masks, pred_boxes, pred_classes, pred_scores,
                  gt_masks, gt_boxes, gt_classes, iou_threshold=0.5):
    """Mean ROI-frame mask IoU over box-matched detections (the mask half
    of `mrcnn/utils.py` compute_ap's `pred_masks`/`gt_masks` overlap path,
    evaluated in the mask head's own 28×28 frame). Unmatched detections
    and unmatched GT contribute nothing (box quality is mAP's job)."""
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return 0.0
    pred_match, _, order = match_predictions(
        pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes,
        iou_threshold,
    )
    ious = []
    for rank, j in enumerate(pred_match):
        if j < 0:
            continue
        i = order[rank]
        pm = np.asarray(pred_masks[i]) > 0.5
        gm = _crop_mask_np(np.asarray(gt_masks[j]), pred_boxes[i], pm.shape[0])
        union = (pm | gm).sum()
        ious.append((pm & gm).sum() / max(union, 1))
    return float(np.mean(ious)) if ious else 0.0


def compute_map_range(pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes,
                      thresholds=None):
    """COCO mAP@[.5:.95] (`mrcnn/utils.py:758-774`)."""
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)
    aps = [
        compute_ap(pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes, t)[0]
        for t in thresholds
    ]
    return float(np.mean(aps))


def coco_map(preds, gts, thresholds=None, max_dets=100, sim_key=None):
    """Dataset-level mAP under the COCO evaluation definition.

    Unlike the per-image-averaged `compute_ap` (Mask-RCNN utils
    semantics), this follows what pycocotools computes — the definition
    behind the reference's published numbers
    (`Mask_RCNN/samples/coco/coco.py:342-398` delegates to COCOeval):

      * evaluation is PER CATEGORY: detections only compete within their
        class, and the final mAP is the mean over categories that have
        ground truth (categories without GT are excluded, not zero);
      * matches accumulate ACROSS the whole dataset into one score-ranked
        list per category before the PR curve is built;
      * AP integrates the monotone precision envelope at 101 recall
        points; the per-image detection list is capped at `max_dets`.

    Args:
      preds: per-image dicts with 'boxes' (P,4), 'classes' (P,),
        'scores' (P,) [+ extra arrays when `sim_key` is used].
      gts: per-image dicts with 'boxes' (G,4), 'classes' (G,).
      sim_key: optional callable (pred_dict, gt_dict) → (P, G) similarity
        matrix replacing box IoU (e.g. OKS for keypoint AP).

    Returns {'map': mAP@[.5:.95], 'map50': AP@0.5, 'per_class': {c: AP}}.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)
    thresholds = np.asarray(thresholds)
    cats = sorted(
        {int(c) for gt in gts for c in np.asarray(gt["classes"]).tolist()}
    )
    ap_by_cat_thr = {}
    for c in cats:
        # (score, matched?) per threshold, accumulated across images
        scores_all = []
        matched_all = [[] for _ in thresholds]
        num_gt = 0
        for pred, gt in zip(preds, gts):
            gsel = np.asarray(gt["classes"]) == c
            gb = np.asarray(gt["boxes"], np.float64)[gsel]
            num_gt += int(gsel.sum())
            psel = np.asarray(pred["classes"]) == c
            pb = np.asarray(pred["boxes"], np.float64)[psel]
            ps = np.asarray(pred["scores"], np.float64)[psel]
            order = np.argsort(-ps)[:max_dets]
            pb, ps = pb[order], ps[order]
            if sim_key is not None:
                sim = np.asarray(sim_key(pred, gt))[psel][order][:, gsel]
            elif len(gb) and len(pb):
                sim = _iou_matrix_np(pb, gb)
            else:
                sim = np.zeros((len(pb), len(gb)))
            scores_all.append(ps)
            for ti, t in enumerate(thresholds):
                gt_used = np.zeros(len(gb), bool)
                m = np.zeros(len(pb), bool)
                for i in range(len(pb)):
                    if not len(gb):
                        break
                    j = -1
                    best = t
                    for jj in range(len(gb)):
                        if gt_used[jj] or sim[i, jj] < best:
                            continue
                        best = sim[i, jj]
                        j = jj
                    if j >= 0:
                        gt_used[j] = True
                        m[i] = True
                matched_all[ti].append(m)
        if num_gt == 0:
            continue
        scores_cat = np.concatenate(scores_all) if scores_all else np.zeros(0)
        order = np.argsort(-scores_cat)
        for ti in range(len(thresholds)):
            m = (
                np.concatenate(matched_all[ti])
                if matched_all[ti]
                else np.zeros(0, bool)
            )
            flags = np.where(m[order], 0, -1)  # _ap_from_matches wants ≥0=TP
            ap, _, _ = _ap_from_matches(flags, num_gt, "coco101")
            ap_by_cat_thr[(c, ti)] = ap
    if not ap_by_cat_thr:
        return {"map": 0.0, "map50": 0.0, "per_class": {}}
    cats_with_gt = sorted({c for c, _ in ap_by_cat_thr})
    per_class = {
        c: float(np.mean([ap_by_cat_thr[(c, ti)]
                          for ti in range(len(thresholds))]))
        for c in cats_with_gt
    }
    t50 = int(np.argmin(np.abs(thresholds - 0.5)))
    map50 = float(np.mean([ap_by_cat_thr[(c, t50)] for c in cats_with_gt]))
    return {
        "map": float(np.mean(list(per_class.values()))),
        "map50": map50,
        "per_class": per_class,
    }


def oks_matrix(pred_kps, gt_kps, gt_areas, sigmas=None, gt_vis=None):
    """Object-keypoint-similarity matrix (the COCO keypoint task metric):

        OKS_pg = Σ_i exp(−d_pgi² / (2 s_g² κ_i²)) · [v_gi > 0] / Σ_i [v_gi > 0]

    with d the per-keypoint distance, s² the GT object area and κ = 2σ the
    published per-keypoint constants.

    Args:
      pred_kps: (P, K, 2) xy; gt_kps: (G, K, 2) xy; gt_areas: (G,).
      sigmas: (K,) falloff constants (default COCO_KP_SIGMAS when K=17,
        else a uniform 0.08).
      gt_vis: optional (G, K) visibility (>0 counts); default all visible.

    Returns (P, G) float64.
    """
    pred_kps = np.asarray(pred_kps, np.float64)
    gt_kps = np.asarray(gt_kps, np.float64)
    P, K = pred_kps.shape[:2]
    G = gt_kps.shape[0]
    if P == 0 or G == 0:
        return np.zeros((P, G))
    if sigmas is None:
        sigmas = COCO_KP_SIGMAS if K == 17 else np.full(K, 0.08)
    vars_ = (2.0 * np.asarray(sigmas)) ** 2
    if gt_vis is None:
        gt_vis = np.ones((G, K))
    vis = (np.asarray(gt_vis) > 0).astype(np.float64)  # (G, K)
    d2 = ((pred_kps[:, None] - gt_kps[None]) ** 2).sum(-1)  # (P, G, K)
    s2 = np.maximum(np.asarray(gt_areas, np.float64), 1.0)  # (G,)
    e = d2 / (2.0 * s2[None, :, None] * vars_[None, None, :] + 1e-12)
    num = (np.exp(-e) * vis[None]).sum(-1)
    den = np.maximum(vis.sum(-1), 1.0)[None]
    return num / den


def compute_keypoint_ap(pred_kps, pred_scores, gt_kps, gt_areas,
                        thresholds=None, sigmas=None, gt_vis=None):
    """Keypoint AP: the box-AP machinery with OKS as the similarity
    (single 'person' category — the COCO keypoint task shape;
    `mask-rcnn.pytorch/BENCHMARK.md:231-` is reported under this metric).

    Returns {'kp_ap': AP@OKS[.5:.95], 'kp_ap50': AP@OKS=.5}.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)
    P, G = len(pred_kps), len(gt_kps)
    if G == 0:
        v = 1.0 if P == 0 else 0.0
        return {"kp_ap": v, "kp_ap50": v}
    if P == 0:
        return {"kp_ap": 0.0, "kp_ap50": 0.0}
    sim = oks_matrix(pred_kps, gt_kps, gt_areas, sigmas, gt_vis)
    ones_p, ones_g = np.ones(P), np.ones(G)
    dummy_pb = np.zeros((P, 4))
    dummy_gb = np.zeros((G, 4))
    aps = []
    ap50 = 0.0
    for t in thresholds:
        pm, _, _ = match_predictions(
            dummy_pb, ones_p, np.asarray(pred_scores), dummy_gb, ones_g,
            iou_threshold=t, sim=sim,
        )
        ap, _, _ = _ap_from_matches(pm, G, "coco101")
        aps.append(ap)
        if abs(t - 0.5) < 1e-9:
            ap50 = ap
    return {"kp_ap": float(np.mean(aps)), "kp_ap50": float(ap50)}
