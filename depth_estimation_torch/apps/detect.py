"""CLI: object detection and instance masks, with optional mask-guided
depth (counterpart of the JAX package's `apps/detect.py`).

  python -m depth_estimation_torch.apps.detect --image in.png --out det.png
      [--params maskrcnn.pt] [--right right.png --depth-out depth.pfm]
      [--splash splash.png] [--rle-out masks.txt] [--device cuda|cpu]

Runs `MaskRCNN` (blocks (2, 2, 2, 2), FPN 128; random weights from seed 0
unless --params names a `torch.save`d state dict, as `train_detect --out`
writes), draws the detections and, given a right view, composites
per-instance phase-correlation disparities into a segment depth map.
Prints a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default=None, help="detections PNG")
    ap.add_argument("--params", default=None, help="MaskRCNN state dict (torch.save)")
    ap.add_argument("--right", default=None, help="right view for mask depth")
    ap.add_argument("--depth-out", default=None)
    ap.add_argument("--splash", default=None,
                    help="color-splash PNG (gray except detected instances)")
    ap.add_argument("--rle-out", default=None,
                    help="write instance masks as submission-format RLE lines")
    ap.add_argument("--num-classes", type=int, default=81)
    ap.add_argument("--detections", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models.detection.rcnn import MaskRCNN
    from ..utils.io import read_image, write_pfm
    from ..utils.visualize import color_splash, draw_detections, paste_roi_masks, save_image

    model = MaskRCNN(num_classes=args.num_classes, num_detections=args.detections,
                     blocks=(2, 2, 2, 2), fpn_dim=128, device=args.device)
    dev = next(model.parameters()).device
    if args.params:
        model.load_state_dict(torch.load(args.params, map_location=dev, weights_only=True))
    img_np = read_image(args.image).astype(np.float32)
    with torch.no_grad():
        out = model(torch.as_tensor(img_np, device=dev))
    out = {k: v.cpu().numpy() for k, v in out.items() if k in ("boxes", "classes", "scores",
                                                               "valid", "masks")}
    result = {"num_valid": int(out["valid"].sum()), "scores": out["scores"].round(3).tolist(),
              "device": str(dev)}
    if args.out:
        save_image(args.out, draw_detections(img_np, out["boxes"], out["classes"],
                                             masks=out["masks"], valid=out["valid"]))
        result["out"] = args.out

    h, w = img_np.shape[:2]
    full = None
    if (args.right and args.depth_out) or args.splash or args.rle_out:
        full = paste_roi_masks(out["boxes"], out["masks"], h, w, valid=out["valid"])
    if args.splash:
        save_image(args.splash, color_splash(img_np, full))
        result["splash"] = args.splash
    if args.rle_out:
        from ..data.coco import masks_to_submission

        with open(args.rle_out, "w") as f:
            f.write(masks_to_submission(args.image, full, out["scores"]) + "\n")
        result["rle_out"] = args.rle_out
    if args.right and args.depth_out:
        from ..models.maskdepth import composite_mask_depth

        right = torch.as_tensor(read_image(args.right).astype(np.float32), device=dev)
        depth = composite_mask_depth(torch.as_tensor(img_np, device=dev), right,
                                     torch.as_tensor(full, dtype=torch.float32, device=dev))
        write_pfm(args.depth_out, depth.cpu().numpy())
        result["depth_out"] = args.depth_out
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
