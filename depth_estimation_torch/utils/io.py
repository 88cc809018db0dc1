"""Image / depth-map IO: PNG (via PIL), PFM, PGM.

Capability parity with the reference readers (`crf/utils.py:46-109` in the
reference repo): `read_image` returns float RGB in [0,1]; `read_pfm` handles
both endiannesses and returns the image flipped to top-down row order;
`read_pgm` handles 8- and 16-bit raw (P5) files with comments.

Pure numpy on the host — device placement is the caller's job.
"""
from __future__ import annotations

import re
import struct

import numpy as np

__all__ = ["read_image", "read_pfm", "write_pfm", "read_pgm", "grayscale"]


def read_image(path) -> np.ndarray:
    """Load an image file as float RGB array in [0, 1], shape (h, w, 3)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float64)
    return arr / 255.0


def grayscale(img: np.ndarray) -> np.ndarray:
    """Luma-weighted grayscale of an (h, w, 3) RGB array."""
    w = np.array([0.2125, 0.7154, 0.0721], dtype=img.dtype)
    return img @ w


def read_pfm(path) -> np.ndarray:
    """Read a PFM file → (h, w) or (h, w, 3) float32 array, top-down rows.

    PFM stores rows bottom-up; we flip so row 0 is the top, matching the
    reference reader's convention.
    """
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("latin-1")
        width, height = (int(x) for x in re.findall(r"\d+", dims))
        scale = float(f.readline().decode("latin-1").strip())
        little_endian = scale < 0
        count = width * height * channels
        buf = f.read(count * 4)
        fmt = ("<" if little_endian else ">") + str(count) + "f"
        data = np.array(struct.unpack(fmt, buf), dtype=np.float32)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path, img: np.ndarray) -> None:
    """Write a float array as a little-endian PFM (1 or 3 channels)."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        header = b"Pf\n"
    elif img.ndim == 3 and img.shape[2] == 3:
        header = b"PF\n"
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pgm(path) -> np.ndarray:
    """Read a raw (P5) PGM file → (h, w) uint8/uint16 array.

    Handles '#' comments between header tokens; >8-bit maxval files are
    big-endian per the netpbm spec.
    """
    with open(path, "rb") as f:
        buf = f.read()
    match = re.search(
        rb"(^P5\s(?:\s*#.*[\r\n])*"
        rb"(\d+)\s(?:\s*#.*[\r\n])*"
        rb"(\d+)\s(?:\s*#.*[\r\n])*"
        rb"(\d+)\s(?:\s*#.*[\r\n]\s)*)",
        buf,
    )
    if match is None:
        raise ValueError(f"{path}: not a raw PGM file")
    header, width, height, maxval = match.groups()
    width, height, maxval = int(width), int(height), int(maxval)
    dtype = np.dtype("u1") if maxval < 256 else np.dtype(">u2")
    img = np.frombuffer(
        buf, dtype=dtype, count=width * height, offset=len(header)
    ).reshape((height, width))
    return img.astype(np.uint8 if maxval < 256 else np.uint16)
