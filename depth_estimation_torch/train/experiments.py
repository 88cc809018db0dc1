"""Training experiments of the dense CRF (counterpart of the JAX package's
`train/experiments.py`, its CRF experiments):

- `TrainableDenseCRF` / `train_tsukuba_crf`: learn the guide scales, a
  projection of guidance features into the guide and the Charbonnier
  compatibility by Adam on the masked MSE of the decoded disparity,
  differentiating end to end through the permutohedral lattice;
- `train_uncertainty`: the refiner with an uncertainty head, masked L1;
- `train_upsampler`: the CRF depth upsampler, masked L1;
- `train_detection_items` (with `train_detection_shapes` and
  `train_detection_coco`): `MaskRCNN` on fixed-shape items by the full
  multi-task loss (RPN objectness + RPN box + ROI class + ROI box + mask
  BCE, + keypoint CE), then mAP@0.5 (+ mask IoU, keypoint AP);
- `train_detection_shapes_batched`: the same loss averaged over a batch of
  shapes images, data-parallel over a mesh's data ranks (`Trainer`);
- `evaluate_detection`: batched inference and dataset mAP, split over the
  data ranks too.

`torch.optim.Adam` takes the place of `optax.adam`; both step by
m̂/(√v̂ + 1e-8). Each function returns (model, history); the history holds
the loss of every step (before its update), the metric before and after
training (mAP after, for detection), and the host seconds of every step
(each ends when its loss reaches the host). Random draws come from
generators seeded by `seed`.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch
import torch.nn as nn

from ..crf.compat import charb_apply, charb_init
from ..crf.guides import pixel_coords
from ..crf.meanfield import crf_as_rnn
from ..models.features import FeatureCNN, VGG16Features, random_features
from ..models.refiner import CRFDepthUpsampler, CRFWithUncertainty, _params
from ..ops.costvolume import cost_volume, expected_disparity
from ..ops.permutohedral import build_plan, lattice_filter_planned
from ..utils.device import resolve_device
from ..utils.weights import load_jax_params
from .metrics import masked_l1, masked_mse

__all__ = ["TrainableDenseCRF", "train_tsukuba_crf", "train_uncertainty", "train_upsampler",
           "train_detection_items", "train_detection_shapes", "train_detection_coco",
           "train_detection_shapes_batched", "evaluate_detection", "detection_item_tensors",
           "detection_loss_parts", "clip_grad_global_norm_"]


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


class TrainableDenseCRF(nn.Module):
    """The trainable dense CRF; the JAX package's `trainable_crf_init`
    (parameters `proj_w`, `proj_b`, `log_s_ij`, `log_s_rgb`, `log_s_feat`,
    `mu.gamma`, `mu.log_s`) and `trainable_crf_forward` (`forward`). With
    `cnn`, a `FeatureCNN` computes the guidance features from the image
    and trains with the CRF (its parameters under `cnn.`)."""

    def __init__(self, d_feat: int = 16, d_proj: int = 3, gamma: float = 0.05,
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 cnn: FeatureCNN | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        w = torch.randn(d_feat, d_proj, generator=generator, dtype=dtype) * (1.0 / np.sqrt(d_feat))
        self.proj_w = nn.Parameter(w.to(dev))
        self.proj_b = nn.Parameter(torch.zeros(d_proj, dtype=dtype, device=dev))
        for name, s in (("log_s_ij", 0.1), ("log_s_rgb", 0.1), ("log_s_feat", 10.0)):
            setattr(self, name, nn.Parameter(torch.log(torch.tensor(s, dtype=dtype, device=dev))))
        self.mu = _params(charb_init(gamma, dtype, dev))
        self.cnn = cnn

    def forward(self, logits: torch.Tensor, img: torch.Tensor, feats: torch.Tensor | None = None,
                niters: int = 5) -> torch.Tensor:
        """Refined (h, w, L) logits; the guide is [ij/s_ij, rgb/s_rgb,
        (feats·proj_w + proj_b)/s_feat] with s = exp(log_s), its plan built
        from the detached guide at capacity pow2 ≥ 2n (capped at n·(d+1))."""
        h, w, L = logits.shape
        if feats is None:
            feats = self.cnn(img)
        projected = feats @ self.proj_w + self.proj_b
        guide = torch.cat([pixel_coords(h, w, img.dtype, img.device) / torch.exp(self.log_s_ij),
                           img / torch.exp(self.log_s_rgb),
                           projected / torch.exp(self.log_s_feat)], dim=-1)
        ref = guide.reshape(h * w, -1)
        cap = min(1 << (2 * h * w - 1).bit_length(), h * w * (ref.shape[1] + 1))
        plan = build_plan(ref.detach(), max_vertices=cap)

        def message_fn(Q):
            flat = Q.reshape(h * w, L)
            return (lattice_filter_planned(flat, ref, plan) - flat).reshape(h, w, L)

        return crf_as_rnn(logits, message_fn, lambda Q: charb_apply(self.mu, Q), niters)


def _fit(opt: torch.optim.Optimizer, loss_fn, batches, num_steps: int):
    """`num_steps` Adam steps cycling over `batches`; per-step losses and
    host seconds."""
    losses, seconds = [], []
    for i in range(num_steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(*batches[i % len(batches)])
        loss.backward()
        opt.step()
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    return losses, seconds


def train_tsukuba_crf(left, right, gt, num_steps: int = 300, lr: float = 3e-2,
                      num_disp: int = 16, niters: int = 5, d_feat: int = 16, seed: int = 0,
                      guidance: str = "random", guidance_params: dict | None = None,
                      device=None):
    """Adam training of the CRF on one stereo pair, masked MSE on gt > 0.

    `guidance` picks the features fed to the trainable guide:
      - 'random': seeded random-projection features (training-free);
      - 'cnn': a `FeatureCNN` trained jointly with the CRF;
      - 'vgg': `VGG16Features`, frozen, with `guidance_params` (a JAX
        params tree, loaded by `utils.weights.load_jax_params`); without
        them a random-init VGG16 runs and a UserWarning says that this is
        not the reference's pretrained protocol.

    Returns (model, history) with history['loss'] per step,
    'mse_before'/'mse_after' and 'step_seconds'.
    """
    dev = resolve_device(device)
    left_t, gt_t = _tensor(left, dev), _tensor(gt, dev)
    mask = (gt_t > 0).float()
    logits = -cost_volume(left_t, _tensor(right, dev), num_disp, 9)

    feats, cnn = None, None
    if guidance == "random":
        feats = random_features(left_t, out_dim=d_feat,
                                generator=torch.Generator().manual_seed(seed))
    elif guidance == "cnn":
        cnn = FeatureCNN(out_dim=d_feat, generator=torch.Generator().manual_seed(seed + 1),
                         device=dev)
    elif guidance == "vgg":
        vgg = VGG16Features(generator=torch.Generator().manual_seed(seed + 1), device=dev)
        if guidance_params is None:
            warnings.warn(
                "guidance='vgg' without guidance_params runs a RANDOM-init VGG16; pass "
                "pretrained parameters (utils.weights.load_jax_params) for the reference "
                "protocol (pretrained weights are not bundled).", UserWarning, stacklevel=2)
        else:
            load_jax_params(vgg, guidance_params, device=dev)
        with torch.no_grad():
            full = vgg(left_t)
            # a fixed seeded projection of the 960-d taps to d_feat; the
            # trainable proj_w re-mixes it
            proj = torch.randn(full.shape[-1], d_feat,
                               generator=torch.Generator().manual_seed(seed + 2)).to(dev)
            feats = full @ (proj / np.sqrt(full.shape[-1]))
            feats = (feats - feats.mean((0, 1))) / (feats.std((0, 1), unbiased=False) + 1e-6)
    else:
        raise ValueError(f"unknown guidance {guidance!r}")

    model = TrainableDenseCRF(d_feat=d_feat, generator=torch.Generator().manual_seed(seed),
                              cnn=cnn, device=dev)

    def loss_fn():
        return masked_mse(expected_disparity(model(logits, left_t, feats, niters)), gt_t, mask)

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    with torch.no_grad():
        mse_before = float(loss_fn())
    losses, seconds = _fit(opt, loss_fn, [()], num_steps)
    with torch.no_grad():
        mse_after = float(loss_fn())
    return model, {"loss": losses, "mse_before": mse_before, "mse_after": mse_after,
                   "step_seconds": seconds}


def train_uncertainty(items: list, num_steps: int = 60, lr: float = 1e-3, niters: int = 2,
                      r: int = 15, num_disp: int = 16, d_feat: int = 64, seed: int = 0,
                      unc_weighted: bool = False, device=None):
    """Train the refiner with its uncertainty head end to end by Adam on
    masked L1 (or, with `unc_weighted`, |conf·(d − y)| − log conf). Items
    are dicts with 'left', 'right' (h, w, 3) and 'disparity' (h, w; 0 =
    invalid). Returns (model, history with 'loss', 'l1_before',
    'l1_after', 'step_seconds')."""
    dev = resolve_device(device)
    model = CRFWithUncertainty(d_in=d_feat, generator=torch.Generator().manual_seed(seed),
                               device=dev)

    def prep(item):
        left = _tensor(item["left"], dev)
        logits = -cost_volume(left, _tensor(item["right"], dev), num_disp, 9)
        feats = random_features(left, out_dim=d_feat)
        return logits, left, feats, _tensor(item["disparity"], dev)

    batches = [prep(it) for it in items]

    def loss_fn(logits, img, feats, gt):
        depth, conf = model(logits, img, feats, niters, r)
        if unc_weighted:
            mask = (gt > 0).to(depth.dtype)
            resid = (conf * (depth - gt)).abs() - torch.log(conf + 1e-8)
            return (resid * mask).sum() / mask.sum().clamp_min(1.0)
        return masked_l1(depth, gt)

    def eval_l1():
        with torch.no_grad():
            return float(np.mean([float(masked_l1(model(*b[:3], niters, r)[0], b[3]))
                                  for b in batches]))

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    before = eval_l1()
    losses, seconds = _fit(opt, loss_fn, batches, num_steps)
    return model, {"loss": losses, "l1_before": before, "l1_after": eval_l1(),
                   "step_seconds": seconds}


def train_upsampler(items: list, num_steps: int = 100, lr: float = 3e-3, niters: int = 1,
                    r: int = 5, device=None):
    """Train the CRF depth upsampler by Adam(lr, betas (0.9, 0.9)) on
    masked L1. Items are dicts with 'disp_lowres' (hl, wl), 'image' (h, w,
    3) and 'disparity' (h, w). Returns (model, history with 'loss',
    'l1_before', 'l1_after', 'step_seconds'). The upsampler draws nothing
    at random, so it takes no seed."""
    dev = resolve_device(device)
    model = CRFDepthUpsampler(device=dev)
    batches = [(_tensor(it["disp_lowres"], dev), _tensor(it["image"], dev),
                _tensor(it["disparity"], dev)) for it in items]

    def loss_fn(low, img, gt):
        return masked_l1(model(low, img, niters=niters, r=r), gt)

    def mean_l1():
        with torch.no_grad():
            return float(np.mean([float(loss_fn(*b)) for b in batches]))

    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.9))
    before = mean_l1()
    losses, seconds = _fit(opt, loss_fn, batches, num_steps)
    return model, {"loss": losses, "l1_before": before, "l1_after": mean_l1(),
                   "step_seconds": seconds}


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

# the JAX package's small training model (`train_detection_items` defaults)
_DETECT_DEFAULTS = dict(blocks=(1, 1, 1, 1), fpn_dim=32, num_proposals=32, num_detections=8,
                        score_thresh=-1.0)


def _detection_model(num_classes: int, model_kwargs, seed: int, init_params, dev, **defaults):
    """A seeded `MaskRCNN`, or one holding `init_params` (a full state dict,
    e.g. with a body from `utils.weights.graft_backbone`) in their dtype."""
    from ..models.detection.rcnn import MaskRCNN

    kwargs = {**_DETECT_DEFAULTS, **defaults, **(model_kwargs or {})}
    model = MaskRCNN(num_classes=num_classes, generator=torch.Generator().manual_seed(seed),
                     device=dev, **kwargs)
    if init_params is not None:
        model.to(next(iter(init_params.values())).dtype).load_state_dict(init_params)
    return model


def detection_item_tensors(item: dict, dev, with_masks: bool, with_keypoints: bool) -> dict:
    """An item's image and padded GT as tensors: float32 images, boxes,
    masks and keypoints (the JAX package's dtypes), int64 classes."""
    t = {"image": torch.as_tensor(np.asarray(item["image"], np.float32), device=dev),
         "boxes": torch.as_tensor(np.asarray(item["boxes_padded"], np.float32), device=dev),
         "classes": torch.as_tensor(np.asarray(item["classes_padded"]), device=dev).long(),
         "valid": torch.as_tensor(np.asarray(item["gt_valid"]), device=dev).bool()}
    if with_masks:
        t["masks"] = torch.as_tensor(np.asarray(item["masks_padded"], np.float32), device=dev)
    if with_keypoints:
        t["keypoints"] = torch.as_tensor(np.asarray(item["keypoints_padded"], np.float32),
                                         device=dev)
        t["kp_visible"] = torch.as_tensor(np.asarray(item["kp_visible_padded"]), device=dev).bool()
    return t


def detection_loss_parts(model, t: dict) -> dict:
    """The multi-task loss terms of one item (`detection_item_tensors`): rpn_cls,
    rpn_reg, roi_cls, roi_reg, and mask / keypoint when `t` has their
    targets. Their sum is the training loss."""
    from ..models.detection.losses import (keypoint_targets, mask_loss, roi_losses,
                                           roi_mask_targets, rpn_losses)
    from ..models.detection.rcnn import keypoint_loss

    out = model(t["image"], train=True, gt_boxes=t["boxes"], gt_valid=t["valid"])
    rpn_cls, rpn_reg = rpn_losses(out["rpn_logits"], out["rpn_deltas"], out["anchors"],
                                  t["boxes"], t["valid"])
    roi_cls, roi_reg, tgt_cls, best_gt, fg = roi_losses(
        out["cls_scores"], out["cls_deltas"], out["proposals"], out["proposal_valid"],
        t["boxes"], t["classes"], t["valid"])
    parts = {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "roi_cls": roi_cls, "roi_reg": roi_reg}
    if "masks" in t:
        m = out["mask_logits"].shape[1]
        tgt_masks = roi_mask_targets(t["masks"], best_gt, out["proposals"], size=(m, m))
        parts["mask"] = mask_loss(out["mask_logits"], tgt_cls, tgt_masks, fg)
    if "keypoints" in t:
        tgt_xy, tgt_vis = keypoint_targets(t["keypoints"], t["kp_visible"], best_gt,
                                           out["proposals"], heatmap_size=out["kp_logits"].shape[1])
        parts["keypoint"] = keypoint_loss(out["kp_logits"], tgt_xy, tgt_vis, fg)
    return parts


@torch.no_grad()
def clip_grad_global_norm_(params, max_norm: float) -> None:
    """optax's `clip_by_global_norm`: every gradient becomes g / ‖g‖ ·
    max_norm when the global norm ‖g‖ reaches max_norm (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`), decided on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def train_detection_items(items, num_classes: int, num_steps: int = 50, lr: float = 1e-3,
                          seed: int = 0, model_kwargs: dict | None = None,
                          with_masks: bool | None = None, with_keypoints: bool = False,
                          loss_breakdown: bool = False, eval_items=None, init_params=None,
                          grad_clip: float | None = None, freeze_backbone: bool = False,
                          device=None):
    """Single-device detection training over fixed-shape items.

    Each item carries `image` (h, w, 3), padded GT (`boxes_padded`,
    `classes_padded`, `gt_valid`, and `masks_padded` / `keypoints_padded` +
    `kp_visible_padded` for the mask / keypoint branches) and the unpadded
    `boxes` / `classes` for the mAP@0.5 at the end, over `eval_items` when
    given, else over the training items. `with_masks` defaults to whether
    items carry `masks_padded`. `init_params` is a full `MaskRCNN` state
    dict (the model takes its dtype); `grad_clip` clips by global norm as
    optax does; `freeze_backbone` keeps the ResNet body out of the
    optimizer (and out of the backward). Returns (model, history) with 'loss',
    'step_seconds', 'map50' (+ 'parts', 'mask_iou', 'kp_ap50')."""
    from .eval_detection import compute_ap, compute_keypoint_ap, mask_mean_iou

    dev = resolve_device(device)
    if with_masks is None:
        with_masks = "masks_padded" in items[0]
    extra = {"num_keypoints": items[0]["keypoints_padded"].shape[1]} if with_keypoints else {}
    model = _detection_model(num_classes, model_kwargs, seed, init_params, dev, **extra)
    if freeze_backbone:
        model.ResNetFPN_0.ResNet_0.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr)
    tensors = [detection_item_tensors(it, dev, with_masks, with_keypoints) for it in items]
    history = {"loss": [], "step_seconds": [], "map50": None}
    if loss_breakdown:
        history["parts"] = []
    for i in range(num_steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        parts = detection_loss_parts(model, tensors[i % len(tensors)])
        loss = sum(parts.values())
        loss.backward()
        if grad_clip:
            clip_grad_global_norm_(params, grad_clip)
        opt.step()
        history["loss"].append(loss.item())
        if loss_breakdown:
            history["parts"].append({k: v.item() for k, v in parts.items()})
        history["step_seconds"].append(time.perf_counter() - t0)

    aps, mious, kp_aps = [], [], []
    with torch.no_grad():
        for item in eval_items if eval_items is not None else items:
            out = model(torch.as_tensor(np.asarray(item["image"], np.float32), device=dev),
                        train=False)
            valid = out["valid"].cpu().numpy()
            pb = out["boxes"].cpu().numpy()[valid]
            pc = out["classes"].cpu().numpy()[valid]
            ps = out["scores"].cpu().numpy()[valid]
            aps.append(compute_ap(pb, pc, ps, item["boxes"], item["classes"])[0])
            if with_masks:
                mious.append(mask_mean_iou(out["masks"].cpu().numpy()[valid], pb, pc, ps,
                                           item["masks"], item["boxes"], item["classes"]))
            if with_keypoints and "keypoints" in out and len(item["boxes"]):
                kp_aps.append(compute_keypoint_ap(
                    out["keypoints"].cpu().numpy()[valid], ps, np.asarray(item["keypoints"]),
                    _gt_areas(item["boxes"]))["kp_ap50"])
    history["map50"] = float(np.mean(aps))
    if with_masks:
        history["mask_iou"] = float(np.mean(mious))
    if kp_aps:
        history["kp_ap50"] = float(np.mean(kp_aps))
    return model, history


def _gt_areas(boxes) -> np.ndarray:
    gb = np.asarray(boxes, np.float64)
    return np.maximum(gb[:, 2] - gb[:, 0], 1.0) * np.maximum(gb[:, 3] - gb[:, 1], 1.0)


def train_detection_shapes(num_steps: int = 50, num_items: int = 8, h: int = 64,
                           lr: float = 1e-3, holdout: int = 0, seed: int = 0,
                           model_kwargs: dict | None = None, **kwargs):
    """`train_detection_items` on the procedural shapes dataset (h × h,
    at most 2 shapes an image). `holdout > 0` evaluates on that many items
    drawn from a disjoint seed instead of the training set. Other kwargs
    pass through."""
    from ..data.shapes import NUM_CLASSES, ShapesDetection

    ds = ShapesDetection(num_items=num_items, h=h, w=h, max_shapes=2, seed=seed)
    items = [ds.padded(i) for i in range(num_items)]
    eval_items = None
    if holdout:
        val = ShapesDetection(num_items=holdout, h=h, w=h, max_shapes=2, seed=seed + 1000)
        eval_items = [val.padded(i) for i in range(holdout)]
    return train_detection_items(items, NUM_CLASSES, num_steps=num_steps, lr=lr, seed=seed,
                                 model_kwargs=model_kwargs, eval_items=eval_items, **kwargs)


def train_detection_coco(root: str, ann_file: str, num_steps: int = 100, size: int = 128,
                         max_gt: int = 16, lr: float = 1e-3, max_items: int | None = None,
                         seed: int = 0, model_kwargs: dict | None = None, holdout: int = 0,
                         device=None):
    """`train_detection_items` on a COCO-format dataset: images resized to
    (size, size), GT padded to max_gt, 64 proposals and 16 detections by
    default. `holdout > 0` keeps the last N items for evaluation only."""
    from ..data.coco import COCODetection

    ds = COCODetection(root, ann_file, max_items=max_items)
    items = [ds.padded(i, size=size, max_gt=max_gt) for i in range(len(ds))]
    eval_items = None
    if holdout:
        if holdout >= len(items):
            raise ValueError(f"holdout={holdout} needs at least {holdout + 1} items, "
                             f"dataset has {len(items)}")
        items, eval_items = items[:-holdout], items[-holdout:]
    kwargs = {"num_proposals": 64, "num_detections": 16, **(model_kwargs or {})}
    return train_detection_items(items, ds.num_classes, num_steps=num_steps, lr=lr, seed=seed,
                                 model_kwargs=kwargs, eval_items=eval_items, device=device)


def _stack_detection_batch(items) -> dict:
    """Padded shapes items stacked into batch-leading host tensors."""
    return {"image": torch.as_tensor(np.stack([it["image"] for it in items]).astype(np.float32)),
            "boxes": torch.as_tensor(np.stack([it["boxes_padded"] for it in items])),
            "classes": torch.as_tensor(np.stack([it["classes_padded"] for it in items])).long(),
            "valid": torch.as_tensor(np.stack([it["gt_valid"] for it in items])),
            "masks": torch.as_tensor(np.stack([it["masks_padded"] for it in items]))}


def _batch_mean_loss(model, b: dict) -> torch.Tensor:
    """The mean over a batch's images of each image's summed loss terms."""
    n = b["image"].shape[0]
    return sum(sum(detection_loss_parts(model, {k: v[i] for k, v in b.items()}).values())
               for i in range(n)) / n


def train_detection_shapes_batched(num_steps: int = 20, batch_size: int = 8, num_items: int = 16,
                                   h: int = 64, lr: float = 1e-3, seed: int = 0, mesh=None,
                                   eval_at_end: bool = False, model_kwargs: dict | None = None,
                                   init_params=None, device=None):
    """Multi-image detection training on procedural shapes: the loss of a
    step is the mean over a batch of `batch_size` items (cycling over
    `num_items`) of each image's multi-task loss, with masks, from a seeded
    init or `init_params` (a `MaskRCNN` state dict). With a
    `parallel.mesh.Mesh`, a `Trainer` splits every batch over the 'data'
    ranks and averages their gradients, so the step is the full batch's.
    Returns (model, history) with history['loss'] (batch means), plus
    `evaluate_detection`'s metrics when `eval_at_end`."""
    from ..data.shapes import NUM_CLASSES, ShapesDetection
    from .trainer import Trainer

    dev = resolve_device(device)
    ds = ShapesDetection(num_items=num_items, h=h, w=h, max_shapes=2, seed=seed)
    items = [ds.padded(i) for i in range(num_items)]
    model = _detection_model(NUM_CLASSES, model_kwargs, seed, init_params, dev)
    tr = Trainer(_batch_mean_loss, lambda ps: torch.optim.Adam(ps, lr=lr), mesh=mesh, device=dev)
    state = tr.init(model)
    history = {"loss": [], "step_seconds": []}
    for i in range(num_steps):
        batch = _stack_detection_batch(
            [items[(i * batch_size + j) % num_items] for j in range(batch_size)])
        t0 = time.perf_counter()
        history["loss"].append(tr.update(state, batch))
        history["step_seconds"].append(time.perf_counter() - t0)
    if eval_at_end:
        history.update(evaluate_detection(model, items, mesh=mesh))
    return model, history


def evaluate_detection(model, items, mesh=None, batch_size: int | None = None) -> dict:
    """Batched dataset mAP: inference over batches of items (the tail
    padded by repetition), under a mesh each 'data' rank on its rows with
    the outputs gathered to every rank; matching on the host.

    Returns {'map50': AP@0.5, 'map': mAP@[.5:.95]} averaged over items, the
    dataset-level COCO-definition 'coco_map50' / 'coco_map', and OKS
    keypoint AP 'kp_ap' / 'kp_ap50' when the model decodes keypoints and
    the items carry them."""
    from ..parallel.mesh import shard_batch
    from ..parallel.tiling import gather_rows
    from .eval_detection import coco_map, compute_ap, compute_keypoint_ap, compute_map_range

    dev = next(model.parameters()).device
    n = len(items)
    shard = mesh.axis_size("data") if mesh is not None else 1
    if batch_size is None:
        batch_size = min(max(n, 1), 8 * shard)
        batch_size += (-batch_size) % shard
    keys = ["boxes", "classes", "scores", "valid"] + (["keypoints"] if model.num_keypoints else [])
    outs = []
    with torch.no_grad():
        for lo in range(0, n, batch_size):
            batch = [items[min(lo + j, n - 1)] for j in range(batch_size)]
            images = torch.as_tensor(np.stack([it["image"] for it in batch]).astype(np.float32))
            if mesh is not None:
                images = shard_batch(images, mesh)
            per = [model(im.to(dev), train=False) for im in images]
            # integer and boolean outputs travel as int64 (every backend carries it)
            got = {k: torch.stack([o[k] if o[k].is_floating_point() else o[k].long() for o in per])
                   for k in keys}
            if mesh is not None:
                got = {k: gather_rows(v, mesh, axis="data") for k, v in got.items()}
            got = {k: v.cpu().numpy() for k, v in got.items()}
            outs.extend({k: v[j] for k, v in got.items()} for j in range(min(batch_size, n - lo)))

    ap50s, aps, kp_aps, kp_ap50s, cpreds, cgts = [], [], [], [], [], []
    for item, out in zip(items, outs):
        valid = out["valid"].astype(bool)
        pb, pc, ps = out["boxes"][valid], out["classes"][valid], out["scores"][valid]
        ap50s.append(compute_ap(pb, pc, ps, item["boxes"], item["classes"])[0])
        aps.append(compute_map_range(pb, pc, ps, item["boxes"], item["classes"]))
        cpreds.append({"boxes": pb, "classes": pc, "scores": ps})
        cgts.append({"boxes": np.asarray(item["boxes"]), "classes": np.asarray(item["classes"])})
        if "keypoints" in out and "keypoints" in item and len(item["boxes"]):
            r = compute_keypoint_ap(out["keypoints"][valid], ps, np.asarray(item["keypoints"]),
                                    _gt_areas(item["boxes"]))
            kp_aps.append(r["kp_ap"])
            kp_ap50s.append(r["kp_ap50"])
    res = {"map50": float(np.mean(ap50s)), "map": float(np.mean(aps))}
    cm = coco_map(cpreds, cgts)
    res["coco_map"], res["coco_map50"] = cm["map"], cm["map50"]
    if kp_aps:
        res["kp_ap"], res["kp_ap50"] = float(np.mean(kp_aps)), float(np.mean(kp_ap50s))
    return res
