"""Detection training above toy scale with an imported, grafted backbone
(counterpart of the JAX system's `tools/train_detect_scaled.py`).

  * a Mask-RCNN at ResNet-18 depth: body blocks (2, 2, 2, 2), bottleneck
    base width 64, FPN 128;
  * the body is imported: a synthetic torchvision-layout ResNet checkpoint
    (He-init kernels, random BatchNorm statistics) goes through
    `utils.weights.torch_resnet_params` (BN folding) and `graft_backbone`
    into a freshly initialised `MaskRCNN`;
  * 128×128 shapes images, the full multi-task loss, trained in two phases
    through `train_detection_items`: the heads on the frozen imported body
    for steps // 2, then all layers at lr / 3; mAP@0.5 and mask IoU on
    held-out items drawn from seed + 1000.

    python -m depth_estimation_torch.tools.train_detect_scaled [--steps 300]
        [--size 128] [--device cpu] [--save params.pt] [--resume params.pt]
        [--out result.json]

Prints one JSON line (with the step times of each phase, whether the heads
phase left the grafted body bit-equal, and which parameters the all-layers
phase left unmoved); writes it to `--out` only where given. `--save` and
`--resume` hold the model's state dict (`torch.save`); `--resume` skips the
graft and the heads phase.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..data.shapes import NUM_CLASSES, ShapesDetection
from ..models.detection.rcnn import MaskRCNN
from ..train.experiments import train_detection_items
from ..utils import weights as W
from ..utils.device import resolve_device

__all__ = ["BLOCKS", "BASE_WIDTH", "FPN_DIM", "BODY", "synth_torch_resnet_sd",
           "model_kwargs", "graft", "main"]

BLOCKS = (2, 2, 2, 2)
BASE_WIDTH = 64
FPN_DIM = 128
BODY = "ResNetFPN_0.ResNet_0."  # the ResNet body's prefix in a MaskRCNN state dict


def synth_torch_resnet_sd(blocks=BLOCKS, width=BASE_WIDTH, seed=0) -> dict:
    """Synthetic torchvision-layout ResNet state dict (numpy): He-init conv
    kernels and random BatchNorm statistics, so that the import's BN
    folding runs on non-trivial scales."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        fan_in = cin * k * k
        sd[name + ".weight"] = rng.randn(cout, cin, k, k).astype(np.float32) * np.sqrt(
            2.0 / fan_in)

    def bn(name, c):
        sd[name + ".weight"] = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
        sd[name + ".bias"] = (0.2 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_mean"] = (0.5 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)

    conv("conv1", width, 3, 7)
    bn("bn1", width)
    cin, w = width, width
    for s, n in enumerate(blocks):
        for j in range(n):
            p = f"layer{s + 1}.{j}"
            conv(p + ".conv1", w, cin, 1)
            bn(p + ".bn1", w)
            conv(p + ".conv2", w, w, 3)
            bn(p + ".bn2", w)
            conv(p + ".conv3", w * 4, w, 1)
            bn(p + ".bn3", w * 4)
            if cin != w * 4 or (s > 0 and j == 0):
                conv(p + ".downsample.0", w * 4, cin, 1)
                bn(p + ".downsample.1", w * 4)
            cin = w * 4
        w *= 2
    return sd


def model_kwargs(blocks=BLOCKS, width=BASE_WIDTH, fpn_dim=FPN_DIM) -> dict:
    """The `MaskRCNN` of the run: frozen affine norms and the torchvision
    stride placement, so that the imported body reproduces its source."""
    return dict(blocks=tuple(blocks), fpn_dim=fpn_dim, base_width=width, backbone_norm="affine",
                stride_1x1=W.resnet_import_kwargs("torch")["stride_1x1"], num_proposals=128,
                num_detections=32, score_thresh=-1.0, num_classes=NUM_CLASSES)


def graft(fresh_state: dict, blocks=BLOCKS, width=BASE_WIDTH, seed: int = 0) -> dict:
    """`fresh_state` (a MaskRCNN state dict) with its body replaced by the
    synthetic checkpoint of `seed + 7`, imported with BN folding."""
    imported = W.torch_resnet_params(synth_torch_resnet_sd(blocks, width, seed=seed + 7),
                                     blocks=blocks)
    return W.graft_backbone(fresh_state, imported)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--items", type=int, default=16)
    ap.add_argument("--holdout", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-clip", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--save", default=None, help="write the final state dict here (torch.save)")
    ap.add_argument("--resume", default=None,
                    help="continue from a saved state dict (skips the graft and the heads phase)")
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    kwargs = model_kwargs()
    train_kwargs = {k: v for k, v in kwargs.items() if k != "num_classes"}
    ds = ShapesDetection(num_items=args.items, h=args.size, w=args.size, max_shapes=2,
                         seed=args.seed)
    items = [ds.padded(i) for i in range(args.items)]
    val = ShapesDetection(num_items=args.holdout, h=args.size, w=args.size, max_shapes=2,
                          seed=args.seed + 1000)
    eval_items = [val.padded(i) for i in range(args.holdout)]
    common = dict(model_kwargs=train_kwargs, eval_items=eval_items, loss_breakdown=True,
                  grad_clip=args.grad_clip, device=dev)

    # Two phases, the staged fine-tune of the Matterport protocol: heads on
    # the frozen imported body, then all layers at a lower rate. --resume
    # goes straight to the all-layers phase from a saved state dict.
    t0 = time.perf_counter()
    hist1 = {"loss": [], "step_seconds": []}
    body_unchanged = None
    if args.resume:
        start = torch.load(args.resume, map_location=dev, weights_only=True)
        model, hist = train_detection_items(items, NUM_CLASSES, num_steps=args.steps,
                                            lr=args.lr / 3, seed=args.seed + 1,
                                            init_params=start, **common)
    else:
        fresh = MaskRCNN(generator=torch.Generator().manual_seed(args.seed), device=dev,
                         **kwargs).state_dict()
        start = graft(fresh, seed=args.seed)
        body0 = {k: v.clone() for k, v in start.items() if k.startswith(BODY)}
        heads_steps = args.steps // 2
        model, hist1 = train_detection_items(items, NUM_CLASSES, num_steps=heads_steps,
                                             lr=args.lr, seed=args.seed, init_params=start,
                                             freeze_backbone=True, **common)
        start = model.state_dict()
        body_unchanged = all(torch.equal(v, start[k]) for k, v in body0.items())
        model, hist = train_detection_items(items, NUM_CLASSES, num_steps=args.steps - heads_steps,
                                            lr=args.lr / 3, seed=args.seed, init_params=start,
                                            **common)
    wall = time.perf_counter() - t0
    final = model.state_dict()
    unmoved = sorted(k for k, _ in model.named_parameters() if torch.equal(final[k], start[k]))

    losses = hist1["loss"] + hist["loss"]
    phases = {"heads": hist1["step_seconds"], "all": hist["step_seconds"]}
    result = {
        "config": {
            "blocks": list(BLOCKS), "base_width": BASE_WIDTH, "fpn_dim": FPN_DIM,
            "image": args.size, "steps": args.steps, "train_items": args.items,
            "holdout": args.holdout,
            "backbone": "grafted synthetic torchvision checkpoint (BN-folded import)",
        },
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "loss_curve_every25": losses[::25],
        "heldout_map50": hist["map50"],
        "heldout_mask_iou": hist.get("mask_iou", float("nan")),
        "final_loss_parts": hist["parts"][-1],
        "wall_s": wall,
        "device": str(dev),
        "resumed_from": args.resume,
        "losses_finite": bool(np.isfinite(losses).all()),
        "step_ms_median": {k: statistics.median(v) * 1e3 if v else None
                           for k, v in phases.items()},
        "step_ms": {k: [s * 1e3 for s in v] for k, v in phases.items()},
        "heads_phase_body_unchanged": body_unchanged,
        "params_unmoved_last_phase": unmoved,
    }
    if args.save:
        torch.save(final, args.save)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
