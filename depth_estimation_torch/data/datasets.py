"""Stereo datasets (numpy on the host): the Tsukuba pair, Middlebury 2014
and 2005, KITTI 2015, and an on-disk cache of precomputed cost volumes.

Counterpart of the JAX package's `data/datasets.py`, with the same item
keys, scaling and dtypes:

- `TsukubaPair`: the pair and its ground truth (`truedisp` / 16); the
  directory comes from `DET_TSUKUBA_DIR`, read when a `TsukubaPair` is made.
- `MiddleburyStereo2014`: root/<scene>/{im0.png, im1.png, disp0.pfm}, images
  Gaussian-downsized, GT subsampled and divided by `downsize`, non-finite
  GT set to 0.
- `MiddleburyStereo2005`: the depth-upsampling task on the scene split
  `TRAIN_SCENES_2005` / `VAL_SCENES_2005`; items are (`disp_lowres`,
  `image`, `disparity`), the low-res input being the pyramid-reduced GT
  divided by `downsize`.
- `KITTIStereo2015`: root/{image_2, image_3, disp_occ_0, obj_map}/
  NNNNNN_10.png; disparity is the uint16 PNG / 256.
- `UnaryCache`: one compressed .npz per string key.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.io import read_image, read_pfm, read_pgm

__all__ = [
    "TsukubaPair",
    "MiddleburyStereo2014",
    "MiddleburyStereo2005",
    "KITTIStereo2015",
    "UnaryCache",
    "TRAIN_SCENES_2005",
    "VAL_SCENES_2005",
    "downsize_image",
]


def _gauss1d(x: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    if sigma <= 0:
        return x
    r = max(1, int(np.ceil(3 * sigma)))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="reflect")
    out = np.zeros_like(x)
    for i, w in enumerate(k):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + x.shape[axis])
        out += w * xp[tuple(sl)]
    return out


def downsize_image(img: np.ndarray, factor: int) -> np.ndarray:
    """Anti-aliased integer downsizing: Gaussian blur (σ = factor/2), then
    stride slicing."""
    if factor <= 1:
        return img
    img = _gauss1d(_gauss1d(img, factor / 2.0, 0), factor / 2.0, 1)
    return img[::factor, ::factor]


@dataclass
class TsukubaPair:
    """The Tsukuba pair. GT convention: `truedisp` is 16× the true
    disparity at full resolution."""

    root: str = field(default_factory=lambda: os.environ.get("DET_TSUKUBA_DIR", ""))

    def available(self) -> bool:
        if not self.root:
            return False
        p = Path(self.root)
        return all(
            (p / f).exists() for f in ("imL.png", "imR.png", "truedisp.row3.col3.pgm")
        )

    def load(self, downsize: int = 1):
        p = Path(self.root)
        left = read_image(p / "imL.png")
        right = read_image(p / "imR.png")
        gt = read_pgm(p / "truedisp.row3.col3.pgm").astype(np.float64) / 16.0
        if downsize > 1:
            left = downsize_image(left, downsize)
            right = downsize_image(right, downsize)
            gt = gt[::downsize, ::downsize] / downsize
        return {"left": left, "right": right, "disparity": gt}


@dataclass
class MiddleburyStereo2014:
    """Middlebury 2014 layout: root/<scene>/{im0.png, im1.png, disp0.pfm}."""

    root: str
    downsize: int = 4

    def __post_init__(self):
        root = Path(self.root)
        self.scenes = sorted(d.name for d in root.iterdir()
                             if (d / "im0.png").exists()) if root.exists() else []

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx: int):
        scene = Path(self.root) / self.scenes[idx]
        item = {"left": downsize_image(read_image(scene / "im0.png"), self.downsize),
                "right": downsize_image(read_image(scene / "im1.png"), self.downsize),
                "scene": self.scenes[idx]}
        dpath = scene / "disp0.pfm"
        if dpath.exists():
            gt = read_pfm(dpath)[:: self.downsize, :: self.downsize] / self.downsize
            item["disparity"] = np.where(np.isfinite(gt), gt, 0.0)
        return item


TRAIN_SCENES_2005 = ["Laundry", "Dolls", "Reindeer"]
VAL_SCENES_2005 = ["Art", "Books", "Moebius"]


def _first(scene: Path, *names: str) -> Path:
    """The first of `names` that exists in `scene` (StopIteration if none)."""
    return next(scene / name for name in names if (scene / name).exists())


@dataclass
class MiddleburyStereo2005:
    """Depth-upsampling data: items are (low-res disparity, full-res image,
    full-res GT disparity) for the train or validation scenes found under
    root (view1.png / disp1.png, or im0.png / disp0.pfm)."""

    root: str
    downsize: int = 16
    val: bool = False

    def __post_init__(self):
        scenes = VAL_SCENES_2005 if self.val else TRAIN_SCENES_2005
        self.scenes = [s for s in scenes if (Path(self.root) / s).exists()]

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx: int):
        scene = Path(self.root) / self.scenes[idx]
        img = read_image(_first(scene, "view1.png", "im0.png"))
        gt_path = _first(scene, "disp1.png", "disp0.pfm")
        if gt_path.suffix == ".pfm":
            gt = read_pfm(gt_path)
            gt = np.where(np.isfinite(gt), gt, 0.0)
        else:
            gt = read_image(gt_path)[..., 0] * 255.0
        lowres = downsize_image(gt[..., None], self.downsize)[..., 0] / self.downsize
        return {"disp_lowres": lowres, "image": img, "disparity": gt,
                "scene": self.scenes[idx]}


@dataclass
class UnaryCache:
    """On-disk cache of precomputed cost volumes or features: one
    compressed .npz per string key (scene and config), named by its hash."""

    cache_dir: str

    def _path(self, key: str) -> Path:
        return Path(self.cache_dir) / f"{hashlib.sha1(key.encode()).hexdigest()[:16]}.npz"

    def get(self, key: str):
        p = self._path(key)
        if not p.exists():
            return None
        with np.load(p) as z:
            return {k: z[k] for k in z.files}

    def put(self, key: str, arrays: dict) -> None:
        Path(self.cache_dir).mkdir(parents=True, exist_ok=True)
        np.savez_compressed(self._path(key), **arrays)

    def get_or_compute(self, key: str, fn):
        hit = self.get(key)
        if hit is not None:
            return hit
        out = fn()
        self.put(key, out)
        return out


@dataclass
class KITTIStereo2015:
    """KITTI 2015 scene-flow layout:
    root/{image_2, image_3, disp_occ_0, obj_map}/NNNNNN_10.png."""

    root: str
    downsize: int = 1

    def __post_init__(self):
        left_dir = Path(self.root) / "image_2"
        self.frames = sorted(p.stem for p in left_dir.glob("*_10.png")) if left_dir.exists() else []

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx: int):
        from PIL import Image

        frame, root, k = self.frames[idx], Path(self.root), self.downsize
        item = {"left": downsize_image(read_image(root / "image_2" / f"{frame}.png"), k),
                "right": downsize_image(read_image(root / "image_3" / f"{frame}.png"), k),
                "frame": frame}
        disp_path = root / "disp_occ_0" / f"{frame}.png"
        if disp_path.exists():  # uint16 PNG of 256 × disparity
            raw = np.asarray(Image.open(disp_path), np.float64) / 256.0
            item["disparity"] = raw[::k, ::k] / k
        obj_path = root / "obj_map" / f"{frame}.png"
        if obj_path.exists():
            item["obj_map"] = np.asarray(Image.open(obj_path))[::k, ::k]
        return item
