"""Procedural shapes detection dataset — the detection-CI fixture
(the port's own copy of the JAX package's `data/shapes.py`).

The reference's only self-contained detection harness is the synthetic
shapes dataset (`Mask_RCNN/samples/shapes/shapes.py:63-191`): random
squares/circles/triangles on a noisy background, with boxes, class ids and
instance masks. This is its numpy re-creation: deterministic per (seed,
index), no downloads.

Classes: 0 background, 1 square, 2 circle, 3 triangle.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ShapesDetection", "draw_shape"]

NUM_CLASSES = 4  # bg + 3
NUM_KEYPOINTS = 5  # center + 4 edge midpoints (synthetic landmark set)


def draw_shape(img, mask, shape_id, cx, cy, size, color):
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    if shape_id == 1:  # square
        m = (np.abs(yy - cy) <= size) & (np.abs(xx - cx) <= size)
    elif shape_id == 2:  # circle
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= size**2
    else:  # triangle (upward)
        m = (yy <= cy + size) & (yy >= cy - size) & (
            np.abs(xx - cx) <= (yy - (cy - size)) / 2
        )
    img[m] = color
    mask[m] = True
    return img, mask


@dataclass
class ShapesDetection:
    num_items: int = 16
    h: int = 64
    w: int = 64
    max_shapes: int = 3
    seed: int = 0

    def __len__(self):
        return self.num_items

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed * 1000 + idx)
        img = np.ones((self.h, self.w, 3)) * rng.rand(3) * 0.4
        img += rng.randn(self.h, self.w, 3) * 0.02
        n = rng.randint(1, self.max_shapes + 1)
        boxes, classes, masks, keypoints = [], [], [], []
        for _ in range(n):
            cls = rng.randint(1, NUM_CLASSES)
            size = rng.randint(self.h // 10, self.h // 4)
            cx = rng.randint(size, self.w - size)
            cy = rng.randint(size, self.h - size)
            color = rng.rand(3) * 0.6 + 0.4
            mask = np.zeros((self.h, self.w), bool)
            img, mask = draw_shape(img, mask, cls, cx, cy, size, color)
            boxes.append([cx - size, cy - size, cx + size, cy + size])
            classes.append(cls)
            masks.append(mask)
            # NUM_KEYPOINTS fixed landmarks per instance (synthetic stand-in
            # for COCO's 17 person keypoints): center + 4 edge midpoints.
            keypoints.append(
                [
                    [cx, cy],
                    [cx, cy - size],
                    [cx, cy + size],
                    [cx - size, cy],
                    [cx + size, cy],
                ]
            )
        # occlusion: later shapes overwrite earlier masks
        for i in range(len(masks) - 1):
            for j in range(i + 1, len(masks)):
                masks[i] = masks[i] & ~masks[j]
        return {
            "image": np.clip(img, 0, 1),
            "boxes": np.asarray(boxes, np.float32),
            "classes": np.asarray(classes, np.int32),
            "masks": np.stack(masks),
            "keypoints": np.asarray(keypoints, np.float32),
        }

    def padded(self, idx: int, max_gt: int | None = None):
        """Fixed-shape variant: GT (boxes, classes, masks, keypoints)
        padded to max_gt with a validity mask."""
        item = self[idx]
        max_gt = max_gt or self.max_shapes
        g = len(item["classes"])
        boxes = np.zeros((max_gt, 4), np.float32)
        classes = np.zeros((max_gt,), np.int32)
        valid = np.zeros((max_gt,), bool)
        masks = np.zeros((max_gt, self.h, self.w), np.float32)
        kps = np.zeros((max_gt, NUM_KEYPOINTS, 2), np.float32)
        kp_vis = np.zeros((max_gt, NUM_KEYPOINTS), bool)
        boxes[:g] = item["boxes"]
        classes[:g] = item["classes"]
        valid[:g] = True
        masks[:g] = item["masks"]
        kps[:g] = item["keypoints"]
        kp_vis[:g] = True
        item.update(
            {
                "boxes_padded": boxes,
                "classes_padded": classes,
                "gt_valid": valid,
                "masks_padded": masks,
                "keypoints_padded": kps,
                "kp_visible_padded": kp_vis,
            }
        )
        return item
