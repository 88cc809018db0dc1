"""Detection training through the COCO file format (counterpart of the JAX
system's `tools/train_coco_scaled.py`): json annotations and images on
disk → `data.coco.COCODetection` → `train_detection_coco`, the protocol of
Matterport's `samples/coco/coco.py`.

With no COCO images at hand, the images are the procedural shapes
renderer's, exported as a genuine COCO tree (pngs and a json with polygon
segmentations): a check of the file-format path at scale, not a claim of
COCO-benchmark parity.

    python -m depth_estimation_torch.tools.train_coco_scaled [--steps 3000]
        [--items 120] [--holdout 10] [--device cpu] [--data-dir DIR]
        [--out result.json]

The tree goes to `--data-dir`, or to a temporary directory removed after
the run. Prints one JSON line (without the loss curve); writes the result
with its loss curve to `--out` only where given.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np

from ..data.coco import COCODetection
from ..data.shapes import ShapesDetection
from ..train.experiments import train_detection_coco
from ..utils.device import resolve_device

__all__ = ["export_coco_tree", "MODEL_KWARGS", "main"]

MODEL_KWARGS = dict(blocks=(2, 2, 2, 2), base_width=64, fpn_dim=128, num_proposals=128,
                    num_detections=32, score_thresh=-1.0)


def export_coco_tree(out_dir: str, num_items: int, size: int, seed: int) -> tuple[str, str]:
    """Render shapes items into a COCO directory (images/ and ann.json);
    returns (image directory, annotation path)."""
    from PIL import Image

    ds = ShapesDetection(num_items=num_items, h=size, w=size, max_shapes=3, seed=seed)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    cat_ids = set()
    for i in range(num_items):
        item = ds[i]
        img = np.clip(np.asarray(item["image"]), 0, 1)
        fn = f"{i:05d}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(img_dir, fn))
        images.append({"id": i + 1, "file_name": fn, "height": size, "width": size})
        for box, cls, mask in zip(item["boxes"], item["classes"], item["masks"]):
            x1, y1, x2, y2 = [float(v) for v in box]
            ys, xs = np.where(np.asarray(mask) > 0.5)
            if len(xs) == 0:
                continue
            # the mask's bounding rectangle as a COCO polygon: it rasterizes
            # back to about the mask's box, enough for the mask head's targets
            poly = [float(xs.min()), float(ys.min()),
                    float(xs.max() + 1), float(ys.min()),
                    float(xs.max() + 1), float(ys.max() + 1),
                    float(xs.min()), float(ys.max() + 1)]
            cat_ids.add(int(cls))
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": int(cls),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "segmentation": [poly], "iscrowd": 0,
                "area": float((x2 - x1) * (y2 - y1)),
            })
            ann_id += 1
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": c, "name": f"class{c}"} for c in sorted(cat_ids)]}
    ann_path = os.path.join(out_dir, "ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return img_dir, ann_path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--items", type=int, default=120)
    ap.add_argument("--holdout", type=int, default=10)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--data-dir", default=None,
                    help="where the COCO tree is written (default: a temporary directory)")
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        root, ann = export_coco_tree(args.data_dir or tmp, args.items, args.size, args.seed)
        items_read = len(COCODetection(root, ann))
        t0 = time.perf_counter()
        _, hist = train_detection_coco(root, ann, num_steps=args.steps, size=args.size,
                                       lr=args.lr, seed=args.seed, holdout=args.holdout,
                                       model_kwargs=MODEL_KWARGS, device=dev)
        wall = time.perf_counter() - t0
    result = {
        "config": {"steps": args.steps, "items": args.items, "holdout": args.holdout,
                   "size": args.size,
                   "format": "COCO json + png tree (procedural shapes renders)"},
        "items_read": items_read,
        "loss_first": hist["loss"][0],
        "loss_last": hist["loss"][-1],
        "loss_curve_every25": hist["loss"][::25],
        "heldout_map50": hist["map50"],
        "heldout_mask_iou": hist.get("mask_iou", float("nan")),
        "wall_s": wall,
        "device": str(dev),
        "losses_finite": bool(np.isfinite(hist["loss"]).all()),
        "step_ms_median": statistics.median(hist["step_seconds"]) * 1e3,
        "step_ms": [s * 1e3 for s in hist["step_seconds"]],
    }
    print(json.dumps({k: v for k, v in result.items() if k != "loss_curve_every25"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
