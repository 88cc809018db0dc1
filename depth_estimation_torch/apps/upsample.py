"""CLI: CRF-guided depth super-resolution (counterpart of the JAX
package's `apps/upsample.py`).

  python -m depth_estimation_torch.apps.upsample \
      --disp low.pfm --image full.png --out up.pfm [--device cuda|cpu]

Bilinear upsampling of a low-res disparity to the guide image's
resolution, refined by the image-guided CRF (`CRFDepthUpsampler`). With
--gt it adds the masked L1.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--disp", required=True, help="low-res disparity (PFM)")
    ap.add_argument("--image", required=True, help="full-res guide image")
    ap.add_argument("--out", default=None)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--radius", type=int, default=5)
    ap.add_argument("--labels", type=int, default=18)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models.refiner import CRFDepthUpsampler
    from ..train.metrics import masked_l1
    from ..utils.io import read_image, read_pfm, write_pfm

    model = CRFDepthUpsampler(device=args.device)
    dev = model.crf.mu["gamma"].device
    disp_lo = torch.as_tensor(read_pfm(args.disp), dtype=torch.float32, device=dev)
    img = torch.as_tensor(read_image(args.image), dtype=torch.float32, device=dev)
    with torch.no_grad():
        out = model(disp_lo, img, niters=args.iters, r=args.radius, num_labels=args.labels)
    disp = out.cpu().numpy().astype(np.float32)
    result = {"shape": list(disp.shape), "device": str(dev)}
    if args.out:
        write_pfm(args.out, disp)
        result["out"] = args.out
    if args.gt:
        gt = torch.as_tensor(read_pfm(args.gt), dtype=torch.float32, device=dev)
        result["masked_l1"] = float(masked_l1(out, gt))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
