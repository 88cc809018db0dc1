"""CLI: train the detection family, on the procedural shapes by default or
on a COCO-format dataset (counterpart of the JAX package's
`apps/train_detect.py`).

  python -m depth_estimation_torch.apps.train_detect [--steps 100]
      [--coco-root imgs/ --coco-ann ann.json] [--keypoints]
      [--holdout N] [--out maskrcnn.pt] [--device cuda|cpu]

Trains `MaskRCNN` by the full multi-task loss (RPN objectness and box, ROI
class and box, mask BCE, + keypoint CE with --keypoints) and reports
mAP@0.5 and ROI-frame mask IoU, on held-out items when --holdout is set.
--out saves the model's state dict with `torch.save`.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--items", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--holdout", type=int, default=2,
                    help="evaluate on N held-out items (0 = in-domain training-set eval)")
    ap.add_argument("--keypoints", action="store_true",
                    help="train the keypoint branch too (shapes only)")
    ap.add_argument("--coco-root", default=None)
    ap.add_argument("--coco-ann", default=None)
    ap.add_argument("--out", default=None, help="state dict path (torch.save)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..train.experiments import train_detection_coco, train_detection_shapes

    if args.coco_root and args.coco_ann:
        model, hist = train_detection_coco(
            args.coco_root, args.coco_ann, num_steps=args.steps, size=args.size, lr=args.lr,
            max_items=args.items or None, holdout=args.holdout, device=args.device)
    else:
        model, hist = train_detection_shapes(
            num_steps=args.steps, num_items=args.items, h=args.size, lr=args.lr,
            holdout=args.holdout, with_keypoints=args.keypoints, device=args.device)
    if args.out:
        torch.save(model.state_dict(), args.out)
    print(json.dumps({
        "steps": args.steps,
        "loss_first": hist["loss"][0],
        "loss_last": hist["loss"][-1],
        "map50": hist["map50"],
        "mask_iou": hist.get("mask_iou"),
        "out": args.out,
        "device": str(next(model.parameters()).device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
