"""CLI: spectral segmentation by the lattice Laplacian (the port's
counterpart of the JAX package's `apps/segment.py`).

  python -m depth_estimation_torch.apps.segment \\
      --image in.png --out labels.png [--segments 6] [--device cuda]

Eigenvectors of the bilateral RBF Laplacian (matrix-free LOBPCG over the
permutohedral filter) and k-means. Prints one JSON line: the label map's
shape, the number of segments found and the output path.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default=None, help="label map PNG (color-coded)")
    ap.add_argument("--segments", type=int, default=6)
    ap.add_argument("--eigs", type=int, default=8)
    ap.add_argument("--sigma-color", type=float, default=0.15)
    ap.add_argument("--sigma-pos", type=float, default=0.08)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..ops.spectral import spectral_segment
    from ..utils.io import read_image

    labels = spectral_segment(read_image(args.image), num_segments=args.segments,
                              num_eigs=args.eigs, sigma_color=args.sigma_color,
                              sigma_pos=args.sigma_pos, device=args.device).cpu().numpy()
    result = {"shape": list(labels.shape), "segments_found": int(len(np.unique(labels)))}
    if args.out:
        from PIL import Image

        rng = np.random.RandomState(0)
        palette = rng.randint(0, 255, (args.segments, 3), dtype=np.uint8)
        Image.fromarray(palette[labels]).save(args.out)
        result["out"] = args.out
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
