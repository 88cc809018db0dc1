"""Detection minibatch machinery: aspect-ratio-grouped sampling +
fixed-shape padded collation (the port's own copy of the JAX package's
`data/loader.py`).

Static-shape re-design of the reference's `roi_data` loader stack
(`mask-rcnn.pytorch/lib/roi_data/loader.py:17-259`):

- `RoidbBatchSampler` there groups the dataset by aspect ratio
  (`rank_for_training` / `MinibatchSampler`) so every minibatch contains
  same-orientation images and per-batch padding is minimal;
- `collate_minibatch` splits the batch into per-GPU sub-lists.

Here the same capabilities map onto static-shape data parallelism:

- `aspect_ratio_groups` / `GroupedBatchSampler`: deterministic epoch
  permutation that only forms batches WITHIN an orientation group
  (landscape vs portrait, or finer bins), so one padded shape per
  orientation bin serves the whole epoch (grouping keeps the number
  of distinct shapes at #bins, not #images);
- `collate_detection_batch`: pad images to the batch's static target
  shape (image mean-pad, zero GT-pad with validity masks) and stack into
  batch-leading arrays; a mesh's data ranks each take their rows
  (`parallel.mesh.shard_batch`) — per-device splitting is the sharding,
  not host-side sub-lists.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "aspect_ratio_groups",
    "GroupedBatchSampler",
    "collate_detection_batch",
]


def aspect_ratio_groups(shapes, bins=(1.0,)) -> np.ndarray:
    """Group index per image from (h, w) shapes.

    `bins` are ascending aspect-ratio (w/h) boundaries; the default
    single boundary at 1.0 reproduces the reference's landscape/portrait
    split (`loader.py` ASPECT_GROUPING). Returns (N,) int group ids.
    """
    ar = np.asarray([w / max(h, 1) for h, w in shapes], np.float64)
    return np.searchsorted(np.asarray(bins, np.float64), ar, side="right")


class GroupedBatchSampler:
    """Deterministic epoch iterator yielding index lists of `batch_size`
    drawn from a single aspect-ratio group each.

    Mirrors the reference sampler's guarantees (`loader.py:17-101`): every
    item appears once per epoch (tail batches are filled by wrapping
    within the group, the static-shape analog of its leftover handling),
    batches never mix groups, and the order reshuffles per epoch from
    `seed`.
    """

    def __init__(self, shapes, batch_size: int, bins=(1.0,), seed: int = 0):
        self.batch_size = int(batch_size)
        self.groups = aspect_ratio_groups(shapes, bins)
        self.seed = seed

    def epoch(self, epoch_idx: int = 0):
        rng = np.random.RandomState(self.seed + epoch_idx)
        batches = []
        for g in np.unique(self.groups):
            idx = np.where(self.groups == g)[0]
            idx = idx[rng.permutation(len(idx))]
            for lo in range(0, len(idx), self.batch_size):
                chunk = idx[lo : lo + self.batch_size]
                if len(chunk) < self.batch_size:  # wrap within the group
                    extra = idx[: self.batch_size - len(chunk)]
                    chunk = np.concatenate([chunk, extra])
                batches.append(chunk.tolist())
        order = rng.permutation(len(batches))
        return [batches[i] for i in order]

    def __iter__(self):
        return iter(self.epoch(0))


def collate_detection_batch(items, pad_shape=None, max_gt: int | None = None):
    """Items (dicts with 'image' (h, w, 3), 'boxes' (G, 4), 'classes'
    (G,), optional 'masks' (G, h, w)) → batch-leading fixed-shape arrays.

    Pads every image to `pad_shape` (default: the batch max, rounded up
    to a multiple of 32 so FPN strides divide) with the per-image mean,
    zero-pads GT to `max_gt` with a validity mask. Returns a dict of
    numpy arrays ready for `torch.as_tensor` and `shard_batch` (the
    per-device split of the reference's `collate_minibatch`).
    """
    n = len(items)
    hs = [it["image"].shape[0] for it in items]
    ws = [it["image"].shape[1] for it in items]
    if pad_shape is None:
        r32 = lambda v: -(-v // 32) * 32
        pad_shape = (r32(max(hs)), r32(max(ws)))
    H, W = pad_shape
    G = max_gt or max(max(len(it["boxes"]) for it in items), 1)
    images = np.zeros((n, H, W, 3), np.float32)
    boxes = np.zeros((n, G, 4), np.float32)
    classes = np.zeros((n, G), np.int32)
    valid = np.zeros((n, G), bool)
    has_masks = all("masks" in it for it in items)
    masks = np.zeros((n, G, H, W), np.float32) if has_masks else None
    for i, it in enumerate(items):
        img = np.asarray(it["image"], np.float32)
        h, w = img.shape[:2]
        if h > H or w > W:
            raise ValueError(f"image {img.shape[:2]} exceeds pad {pad_shape}")
        images[i] = img.mean(axis=(0, 1))
        images[i, :h, :w] = img
        g = min(len(it["boxes"]), G)
        if g:
            boxes[i, :g] = np.asarray(it["boxes"], np.float32)[:g]
            classes[i, :g] = np.asarray(it["classes"], np.int32)[:g]
            valid[i, :g] = True
            if has_masks:
                masks[i, :g, :h, :w] = np.asarray(it["masks"], np.float32)[:g]
    out = {
        "image": images,
        "boxes_padded": boxes,
        "classes_padded": classes,
        "gt_valid": valid,
        "pad_shape": (H, W),
        "orig_shapes": list(zip(hs, ws)),
    }
    if has_masks:
        out["masks_padded"] = masks
    return out
