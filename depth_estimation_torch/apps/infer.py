"""CLI: stereo pair → disparity map (counterpart of
the JAX package's `apps/infer.py`).

  python -m depth_estimation_torch.apps.infer \
      --left imL.png --right imR.png --out disp.pfm \
      [--labels 16] [--iters 5] [--backend lattice|dense] [--fast] \
      [--device cuda|cpu]

Writes the refined disparity as PFM (and optionally a PNG preview) and
prints one JSON line; with --gt it adds EPE/bad-2.0 (--gt-scale 16 for the
Tsukuba PGM convention).
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--left", required=True)
    ap.add_argument("--right", required=True)
    ap.add_argument("--out", default=None, help="output PFM path")
    ap.add_argument("--preview", default=None, help="optional PNG preview path")
    ap.add_argument("--gt", default=None, help="ground-truth PFM/PGM for metrics")
    ap.add_argument("--gt-scale", type=float, default=1.0, help="divide GT by this")
    ap.add_argument("--labels", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--window", type=int, default=9)
    ap.add_argument("--sigma-color", type=float, default=0.1)
    ap.add_argument("--sigma-pos", type=float, default=0.1)
    ap.add_argument("--backend", default="lattice", choices=["lattice", "dense"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast", action="store_true",
                    help="calibrate this pair first (measured lattice capacity, "
                         "tiled splat/slice, pinned plan sort); default is the "
                         "uncalibrated config")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models.pipeline import CRFStereoConfig, calibrate_capacity, crf_stereo_infer
    from ..train.metrics import bad_pixel_ratio, epe
    from ..utils.io import read_image, read_pfm, read_pgm, write_pfm

    left = read_image(args.left).astype(np.float32)
    right = read_image(args.right).astype(np.float32)
    cfg = CRFStereoConfig(
        num_disp=args.labels,
        window_size=args.window,
        sigma_color=args.sigma_color,
        sigma_pos=args.sigma_pos,
        niters=args.iters,
        backend=args.backend,
    )
    if args.fast:
        cfg = calibrate_capacity(left, cfg, headroom=3.0, tiled=True, device=args.device)
    out = crf_stereo_infer(left, right, cfg, device=args.device)
    disp = out["disparity"].float().cpu().numpy()

    result = {"shape": list(disp.shape), "backend": args.backend, "device": args.device}
    if args.out:
        write_pfm(args.out, disp)
        result["out"] = args.out
    if args.preview:
        from PIL import Image

        norm = (disp - disp.min()) / max(disp.max() - disp.min(), 1e-9)
        Image.fromarray((norm * 255).astype(np.uint8)).save(args.preview)
        result["preview"] = args.preview
    if args.gt:
        gt = read_pgm(args.gt) if args.gt.endswith(".pgm") else read_pfm(args.gt)
        gt_t = torch.as_tensor(np.asarray(gt, np.float64) / args.gt_scale,
                               dtype=torch.float32, device=out["disparity"].device)
        mask = (gt_t > 0).float()
        result["epe"] = float(epe(out["disparity"], gt_t, mask))
        result["bad2"] = float(bad_pixel_ratio(out["disparity"], gt_t, 2.0, mask))
        result["epe_unary"] = float(epe(out["disparity_unary"], gt_t, mask))
        result["bad2_unary"] = float(bad_pixel_ratio(out["disparity_unary"], gt_t, 2.0, mask))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
