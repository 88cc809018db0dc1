"""CLI: train the dense CRF on a stereo pair (counterpart of the JAX
package's `apps/train_crf.py`).

  python -m depth_estimation_torch.apps.train_crf \
      --left imL.png --right imR.png --gt truedisp.pgm --gt-scale 16 \
      [--steps 300] [--lr 3e-2] [--out params.npz] [--device cuda|cpu]

Adam on the masked MSE against the ground truth, end to end through the
lattice filter. Prints a JSON summary with the MSE before and after and
the learned scales.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--left", required=True)
    ap.add_argument("--right", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--gt-scale", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--labels", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="save learned params (.npz)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..train.experiments import train_tsukuba_crf
    from ..utils.io import read_image, read_pfm, read_pgm

    left = read_image(args.left)
    right = read_image(args.right)
    gt = read_pgm(args.gt) if args.gt.endswith(".pgm") else read_pfm(args.gt)
    gt = np.asarray(gt, np.float64) / args.gt_scale

    model, hist = train_tsukuba_crf(
        left.astype(np.float32), right.astype(np.float32), gt.astype(np.float32),
        num_steps=args.steps, lr=args.lr, num_disp=args.labels, niters=args.iters,
        device=args.device)
    if args.out:
        np.savez(args.out, **{k: v.detach().cpu().numpy() for k, v in model.named_parameters()})
    print(json.dumps({
        "steps": args.steps,
        "mse_before": hist["mse_before"],
        "mse_after": hist["mse_after"],
        "final_loss": hist["loss"][-1],
        "learned_s_ij": torch.exp(model.log_s_ij).item(),
        "learned_s_rgb": torch.exp(model.log_s_rgb).item(),
        "learned_gamma": model.mu["gamma"].item(),
        "out": args.out,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
