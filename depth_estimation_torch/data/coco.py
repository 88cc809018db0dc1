"""COCO-format detection dataset — json loading without pycocotools
(the port's own copy of the JAX package's `data/coco.py`).

Capability of the reference's COCO plumbing (`mask-rcnn.pytorch/lib/
datasets/json_dataset.py`, `Mask_RCNN/samples/coco/coco.py`): parse a
COCO-style annotation json, expose per-image boxes / contiguous class ids /
instance masks. Polygon segmentations are rasterized with an even-odd
scanline fill (numpy); RLE masks (`counts` lists) are decoded directly.

No network, no pycocotools: fixtures for tests are generated synthetically
(`tests/test_coco.py`), and real COCO directories work when present.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.io import read_image

__all__ = [
    "COCODetection",
    "rasterize_polygon",
    "decode_rle",
    "encode_rle",
    "rle_submission_encode",
    "rle_submission_decode",
    "masks_to_submission",
]


def rasterize_polygon(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill of an (N, 2) [x, y] polygon → (h, w) bool."""
    mask = np.zeros((h, w), bool)
    xs, ys = poly[:, 0], poly[:, 1]
    n = len(poly)
    for row in range(int(np.floor(ys.min())), int(np.ceil(ys.max())) + 1):
        if not 0 <= row < h:
            continue
        yc = row + 0.5
        crossings = []
        for i in range(n):
            x0, y0 = xs[i], ys[i]
            x1, y1 = xs[(i + 1) % n], ys[(i + 1) % n]
            if (y0 <= yc < y1) or (y1 <= yc < y0):
                t = (yc - y0) / (y1 - y0)
                crossings.append(x0 + t * (x1 - x0))
        crossings.sort()
        for a, b in zip(crossings[::2], crossings[1::2]):
            lo = max(int(np.ceil(a - 0.5)), 0)
            hi = min(int(np.floor(b - 0.5)) + 1, w)
            if hi > lo:
                mask[row, lo:hi] = True
    return mask


def decode_rle(counts, h: int, w: int) -> np.ndarray:
    """Uncompressed COCO RLE (column-major runs) → (h, w) bool."""
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = not val
    return flat.reshape(w, h).T


def encode_rle(mask: np.ndarray) -> list[int]:
    """(h, w) bool → uncompressed COCO RLE counts. Inverse of `decode_rle`
    (column-major runs, first count is the leading zero run, possibly 0)."""
    flat = np.asarray(mask, bool).T.reshape(-1)
    if flat.size == 0:
        return []
    edges = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], edges, [flat.size]])
    counts = np.diff(bounds).tolist()
    return ([0] + counts) if flat[0] else counts


def rle_submission_encode(mask: np.ndarray) -> str:
    """(h, w) bool → '<start> <len> ...' string, 1-based, column-major.

    The Kaggle/DSB submission RLE of the nucleus sample
    (`Mask_RCNN/samples/nucleus/nucleus.py:302-315`).
    """
    flat = np.asarray(mask, bool).T.reshape(-1)
    g = np.diff(np.concatenate([[0], flat.view(np.uint8), [0]]).astype(np.int8))
    pairs = np.flatnonzero(g).reshape(-1, 2) + 1
    pairs[:, 1] -= pairs[:, 0]
    return " ".join(map(str, pairs.reshape(-1)))


def rle_submission_decode(rle: str, h: int, w: int) -> np.ndarray:
    """Inverse of `rle_submission_encode` (`nucleus.py:318-332`)."""
    vals = list(map(int, rle.split()))
    flat = np.zeros(h * w, bool)
    for s, ln in zip(vals[::2], vals[1::2]):
        flat[s - 1 : s - 1 + ln] = True
    return flat.reshape(w, h).T


def masks_to_submission(image_id: str, masks: np.ndarray, scores) -> str:
    """Instance masks → submission lines, overlaps resolved by score.

    masks: (D, h, w) bool; higher-scoring instances claim contested pixels
    (`nucleus.py:335-355` semantics, (D, h, w) layout). Returns one
    '<image_id>, <rle>' line per non-empty instance (or '<image_id>,' if
    none).
    """
    masks = np.asarray(masks, bool)
    scores = np.asarray(scores)
    if masks.ndim != 3:
        raise ValueError("masks must be (D, h, w)")
    if masks.shape[0] == 0:
        return f"{image_id},"
    order = np.argsort(-scores)
    prio = np.zeros(masks.shape[1:], np.int64)  # 0 = unclaimed
    for rank, i in enumerate(order, start=1):
        claim = masks[i] & (prio == 0)
        prio[claim] = rank
    lines = []
    for rank, i in enumerate(order, start=1):
        m = prio == rank
        if not m.any():
            continue
        lines.append(f"{image_id}, {rle_submission_encode(m)}")
    return "\n".join(lines) if lines else f"{image_id},"


@dataclass
class COCODetection:
    """COCO-style dataset: `root/` images + `ann_file` json.

    Category ids are remapped to contiguous 1..K (0 = background), the
    standard Detectron convention (`json_dataset.py`
    `_class_to_coco_ind` inverse).
    """

    root: str
    ann_file: str
    max_items: int | None = None

    def __post_init__(self):
        with open(self.ann_file) as f:
            data = json.load(f)
        self.categories = sorted(c["id"] for c in data.get("categories", []))
        self.cat_to_contiguous = {c: i + 1 for i, c in enumerate(self.categories)}
        self.class_names = {
            self.cat_to_contiguous[c["id"]]: c.get("name", str(c["id"]))
            for c in data.get("categories", [])
        }
        self.images = {im["id"]: im for im in data["images"]}
        self.anns_by_image: dict = {}
        for ann in data.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.images)
        if self.max_items:
            self.ids = self.ids[: self.max_items]

    @property
    def num_classes(self) -> int:
        return len(self.categories) + 1  # + background

    def __len__(self):
        return len(self.ids)

    def padded(self, idx: int, size: int | None = None, max_gt: int = 16):
        """Fixed-shape training item: image resized to (size, size), boxes
        rescaled, GT padded to max_gt with a validity mask — the static-
        shape contract of the detection train loops (one program shape
        serves every item; the reference's dynamic roidb blobs,
        `lib/roi_data/minibatch.py`, are replaced by padding + masking).
        """
        item = self[idx]
        img = np.asarray(item["image"], np.float32)
        h, w = img.shape[:2]
        boxes = item["boxes"].copy()
        if size is not None and (h, w) != (size, size):
            from PIL import Image

            im8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            img = (
                np.asarray(
                    Image.fromarray(im8).resize((size, size), Image.BILINEAR),
                    np.float32,
                )
                / 255.0
            )
            boxes[:, [0, 2]] *= size / w
            boxes[:, [1, 3]] *= size / h
            if len(item["masks"]):
                # keep masks consistent with the resized image (nearest)
                yy = np.clip((np.arange(size) * h / size).astype(int), 0, h - 1)
                xx = np.clip((np.arange(size) * w / size).astype(int), 0, w - 1)
                item["masks"] = item["masks"][:, yy[:, None], xx[None, :]]
            else:
                item["masks"] = np.zeros((0, size, size), bool)
        g = min(len(item["classes"]), max_gt)
        bp = np.zeros((max_gt, 4), np.float32)
        cp = np.zeros((max_gt,), np.int32)
        vp = np.zeros((max_gt,), bool)
        ih, iw = img.shape[:2]
        mp = np.zeros((max_gt, ih, iw), np.float32)
        bp[:g] = boxes[:g]
        cp[:g] = item["classes"][:g]
        vp[:g] = True
        if len(item["masks"]):
            mp[:g] = item["masks"][:g].astype(np.float32)
        item.update(
            {
                "image": img,
                "boxes": boxes[:g],
                "classes": item["classes"][:g],
                "boxes_padded": bp,
                "classes_padded": cp,
                "gt_valid": vp,
                "masks_padded": mp,
            }
        )
        return item

    def __getitem__(self, idx: int):
        info = self.images[self.ids[idx]]
        h, w = info["height"], info["width"]
        path = Path(self.root) / info["file_name"]
        img = read_image(path) if path.exists() else np.zeros((h, w, 3))
        boxes, classes, masks = [], [], []
        for ann in self.anns_by_image.get(info["id"], []):
            x, y, bw, bh = ann["bbox"]  # COCO xywh
            boxes.append([x, y, x + bw, y + bh])
            classes.append(self.cat_to_contiguous[ann["category_id"]])
            seg = ann.get("segmentation")
            if isinstance(seg, list) and seg:
                m = np.zeros((h, w), bool)
                for poly in seg:
                    pts = np.asarray(poly, float).reshape(-1, 2)
                    m |= rasterize_polygon(pts, h, w)
                masks.append(m)
            elif isinstance(seg, dict) and isinstance(seg.get("counts"), list):
                masks.append(decode_rle(seg["counts"], h, w))
            else:
                m = np.zeros((h, w), bool)
                m[int(y) : int(y + bh), int(x) : int(x + bw)] = True
                masks.append(m)
        return {
            "image": img,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "masks": np.stack(masks) if masks else np.zeros((0, h, w), bool),
            "image_id": info["id"],
        }
