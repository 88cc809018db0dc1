"""The benchmark suite of the port (counterpart of the JAX system's
`tools/bench_suite.py`): one measurement of each of five configurations,

  1. tsukuba_dense    the flagship pair (288×384, 16 labels) through the
                      dense O(n²) oracle: 5 iterations of the unfused mean
                      field (no fused-update kernel), float32 products with
                      TF32 off;
  2. middlebury64     a 994×1482 pair at 64 labels through the lattice: the
                      first Middlebury 2014 scene of `DET_MIDDLEBURY_DIR`
                      cropped to that size where it holds one so large, else
                      the 6-layer synthetic stand-in (disparities to 62); K1
                      5 times a frame;
  3. trainable_step   one forward, backward and Adam step of `CRFasRNN`
                      (lattice backend, trainable 5-D guide, 5 iterations) on
                      the flagship pair;
  4. fullres128       a 1088×1920 pair at 128 labels (disparities to 96); K1w
                      5 times a frame;
  5. serving_batched  `StereoServer` on a batch of 8 copies of the flagship
                      frame, in both batch modes; K1 40 times a batch.

The flagship pair is the Tsukuba pair where `DET_TSUKUBA_DIR` holds it,
else uniform noise from `RandomState(0)`. The lattice configurations are
calibrated as the JAX suite calibrates them (`lattice_cfg`: capacity at
headroom 3, 32-px tiles where the incidence blocks fit its 4 GiB budget,
bf16 incidence blocks where tiled) and run in `bench.py`'s default state,
bf16 mean field and the fused update, so that each runs its kernel (the
JAX suite left them in float32 and unfused). Each time is one call by
`utils.timing.loop_timer` (CUDA events on the GPU; the training step by
its own chain of steps, `serving_batched` by `StereoServer.throughput`).

    python -m depth_estimation_torch.tools.bench_suite [--configs 1,2,5]
        [--reps 5] [--small] [--device cpu] [--out FILE]

`--configs` takes names or 1-based indices; `--small` takes the JAX
suite's small shapes (a 64×96 flagship pair, 96×128 at 16 labels, a batch
of 2). Each configuration prints one JSON line with the JAX suite's keys,
followed by the fused-update kernels' launches per call
(`launches_per_call`; a call of `serving_batched` is a batch), the plan's
occupancy where a lattice pipeline runs (`num_valid`, `tile_overflow`) and
for `tsukuba_dense` the TF32 setting. `--out` also writes the lines to
FILE; nothing else is written. Nothing is retried: a configuration that
fails raises.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace

import numpy as np
import torch

from ..crf.guides import ijrgb_guide, ijrgb_guide_init
from ..data.datasets import MiddleburyStereo2014
from ..data.synthetic import make_stereo_pair
from ..models.pipeline import (CRFStereoConfig, blocked, calibrate_capacity, crf_stereo_infer,
                               stereo_unary)
from ..models.refiner import CRFasRNN
from ..models.serving import StereoServer
from ..ops.costvolume import expected_disparity
from ..ops.cuda import meanfield as K
from ..ops.permutohedral import suggest_capacity, suggest_sort_mode, suggest_tile_u
from ..train.metrics import masked_mse
from ..utils.device import resolve_device
from ..utils.timing import jitter, loop_timer, scalarize
from .profile_stages import load_pair

__all__ = ["CONFIGS", "FULL", "SMALL", "INCIDENCE_BYTES", "TILE_PX", "device_name", "flagship_pair",
           "natural_pair", "lattice_cfg", "trainable_plan", "trainable_loss", "run_config",
           "main"]

# the JAX suite's budget for the incidence tables, counted in float32 (the
# bf16 blocks take half)
INCIDENCE_BYTES = 4 << 30
TILE_PX = 32  # the tiled splat's image blocks
NITERS = 5
# (h, w) of the flagship pair, (h, w, labels) of the two large frames, and
# the serving batch: the JAX suite's full and --small shapes
FULL = {"flagship": (288, 384), "middlebury64": (994, 1482, 64),
        "fullres128": (1088, 1920, 128), "batch": 8}
SMALL = {"flagship": (64, 96), "middlebury64": (96, 128, 16), "fullres128": (96, 128, 16),
         "batch": 2}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--configs", default=None, help="comma list, names or 1-based indices")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--small", action="store_true",
                    help="the JAX suite's small shapes (numbers not comparable)")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    return ap.parse_args(argv)


def _config_names(spec: str | None) -> list[str]:
    if not spec:
        return list(CONFIGS)
    names = []
    for tok in (t.strip() for t in spec.split(",")):
        name = CONFIGS[int(tok) - 1] if tok.isdigit() and 1 <= int(tok) <= len(CONFIGS) else tok
        if name not in CONFIGS:
            raise ValueError(f"unknown config {tok!r}; the configs are {CONFIGS}")
        names.append(name)
    return names


def device_name(dev: torch.device) -> str:
    """The card's name, or 'cpu'."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _shapes(small: bool) -> dict:
    return SMALL if small else FULL


def flagship_pair(small: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The Tsukuba pair at 288×384 where `DET_TSUKUBA_DIR` holds it, else
    (and at the small size) uniform noise from `RandomState(0)`."""
    left, right, _, _ = load_pair(*_shapes(small)["flagship"], device)
    return left, right


def natural_pair(h: int, w: int, max_disp: int, device) -> tuple[torch.Tensor, torch.Tensor, str]:
    """(left, right, source): the first Middlebury 2014 scene under
    `DET_MIDDLEBURY_DIR` (at the dataset's quarter size) cropped to h×w
    where it is that large, else `make_stereo_pair(RandomState(0), h, w,
    num_layers=6, max_disp)`."""
    root = os.environ.get("DET_MIDDLEBURY_DIR")
    if root:
        mb = MiddleburyStereo2014(root)
        if len(mb):
            item = mb[0]
            left, right = item["left"][:h, :w], item["right"][:h, :w]
            if left.shape[:2] == (h, w):
                return _tensor(left, device), _tensor(right, device), "middlebury2014"
    left, right, _ = make_stereo_pair(np.random.RandomState(0), h, w, num_layers=6,
                                      max_disp=max_disp)
    return _tensor(left, device), _tensor(right, device), "synthetic_layers"


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def lattice_cfg(labels: int, left: torch.Tensor, device) -> CRFStereoConfig:
    """The JAX suite's lattice configuration for `left`: capacity at
    headroom 3 of its occupancy, 32-px tiles where the incidence blocks
    fit INCIDENCE_BYTES, bf16 blocks where tiled; in the bench's state,
    bf16 mean field and the fused update."""
    cfg = calibrate_capacity(left, CRFStereoConfig(num_disp=labels, niters=NITERS),
                             headroom=3.0, tiled=True, tile_px=TILE_PX,
                             max_incidence_bytes=INCIDENCE_BYTES, device=device)
    return replace(cfg, tile_bf16=cfg.tile_px is not None, compute_dtype="bf16",
                   fused_update=True)


def trainable_plan(left: torch.Tensor, tiled: bool = True) -> dict:
    """The lattice options of the training step, calibrated on the guide at
    `CRFasRNN`'s initial scales as the JAX suite's `trainable_step` does:
    the capacity at headroom 8 (training moves the scales and so the
    occupancy); where `tiled` and h and w are whole tiles, 32-px tiles with
    bf16 incidence blocks, tile_u at headroom 2 and the suggested sort
    mode."""
    h, w = left.shape[:2]
    g0 = ijrgb_guide(ijrgb_guide_init(device=left.device), left).detach()
    ref0 = g0.reshape(-1, g0.shape[-1])
    cap = suggest_capacity(ref0, headroom=8.0)
    if not tiled or h % TILE_PX or w % TILE_PX:
        return {"max_vertices": cap}
    return dict(max_vertices=cap, tile_px=TILE_PX, tile_bf16=True,
                sort_mode=suggest_sort_mode(ref0),
                tile_u=suggest_tile_u(blocked(g0, TILE_PX), TILE_PX * TILE_PX, cap,
                                      headroom=2.0))


def trainable_loss(model: CRFasRNN, left, logits, gt, mask, niters: int,
                   plan: dict) -> torch.Tensor:
    """The training step's loss: the masked mean squared error of the
    expected disparity of the CRF's refined logits."""
    refined = model(left, logits, niters=niters, **plan)
    return masked_mse(expected_disparity(refined), gt, mask)


def _launches(fn):
    """fn's result and each fused-update kernel's launches during it."""
    before = K.launch_counts()
    out = fn()
    after = K.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def _seconds(fn, left: torch.Tensor, reps: int, dev) -> float:
    """Seconds a call of fn(left), by `loop_timer`: a chain of calls, each
    on `left` jittered by the chain's scalar."""
    return loop_timer(lambda a: a + scalarize(fn(jitter(left, a))), reps=reps, device=dev)


def _occupancy(out: dict) -> dict:
    plan = out["plans"][0]
    return {"num_valid": int(plan.num_valid),
            "tile_overflow": None if plan.tile_overflow is None else int(plan.tile_overflow)}


def _tsukuba_dense(args, dev) -> dict:
    left, right = flagship_pair(args.small, dev)
    h, w = left.shape[:2]
    cfg = CRFStereoConfig(num_disp=16, niters=NITERS, backend="dense")

    def fn(x):
        return crf_stereo_infer(x, right, cfg, device=dev)["disparity"]

    # ‖a‖² + ‖b‖² − 2a·b loses the small distances if a·b is taken in TF32
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, per_call = _launches(lambda: fn(left))
        dt = _seconds(fn, left, args.reps, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    return {"config": "tsukuba_dense", "metric": "pipeline_ms", "value": dt * 1e3,
            "unit": f"ms ({h}x{w}, L=16, dense O(n^2))", "h": h, "w": w, "labels": 16,
            "niters": NITERS, "device": device_name(dev), "launches_per_call": per_call,
            "allow_tf32": False}


def _lattice_frame(name: str, h: int, w: int, labels: int, max_disp: int, reps: int, dev,
                   metric: str) -> dict:
    left, right, source = natural_pair(h, w, max_disp, dev)
    cfg = lattice_cfg(labels, left, dev)
    occupancy, per_call = _launches(
        lambda: _occupancy(crf_stereo_infer(left, right, cfg, device=dev)))
    dt = _seconds(lambda x: crf_stereo_infer(x, right, cfg, device=dev)["disparity"], left,
                  reps, dev)
    if metric == "frames_per_s":
        head = {"metric": metric, "value": 1.0 / dt, "unit": f"frames/s/chip ({h}x{w}, L={labels})"}
    else:
        head = {"metric": metric, "value": cfg.niters / dt,
                "unit": f"iters/s/chip ({h}x{w}, L={labels}, d=5 bilateral)"}
    return {"config": name, **head, "pipeline_ms": dt * 1e3, "source": source,
            "max_vertices": cfg.max_vertices, "device": device_name(dev),
            "launches_per_call": per_call, **occupancy}


def _middlebury64(args, dev) -> dict:
    h, w, L = _shapes(args.small)["middlebury64"]
    return _lattice_frame("middlebury64", h, w, L, L - 2, args.reps, dev,
                          "crf_meanfield_iters_per_s")


def _fullres128(args, dev) -> dict:
    h, w, L = _shapes(args.small)["fullres128"]
    return _lattice_frame("fullres128", h, w, L, min(L - 2, 96), max(args.reps // 2, 2), dev,
                          "frames_per_s")


def _trainable_step(args, dev) -> dict:
    left, right = flagship_pair(args.small, dev)
    h, w = left.shape[:2]
    L = 16
    logits = -stereo_unary(left, right, CRFStereoConfig(num_disp=L))
    plan = trainable_plan(left, tiled=not args.small)
    gt, mask = torch.zeros(h, w, device=dev), torch.ones(h, w, device=dev)
    model = CRFasRNN(backend="lattice", device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-2)  # eps 1e-8, as optax.adam's

    def step(acc):
        opt.zero_grad(set_to_none=True)
        loss = trainable_loss(model, left, logits, gt, mask, NITERS, plan)
        loss.backward()
        opt.step()
        return acc + loss.detach()

    _, per_call = _launches(lambda: step(torch.zeros((), device=dev)))
    dt = loop_timer(step, reps=args.reps, device=dev)
    return {"config": "trainable_step", "metric": "train_step_ms", "value": dt * 1e3,
            "unit": f"ms fwd+bwd+adam ({h}x{w}, L={L}, lattice VJP)",
            "device": device_name(dev), "launches_per_call": per_call}


def _serving_batched(args, dev) -> dict:
    left, right = flagship_pair(args.small, dev)
    B = _shapes(args.small)["batch"]
    lb, rb = left.expand(B, *left.shape), right.expand(B, *right.shape)
    cfg = lattice_cfg(16, left, dev)
    stats, per_batch = {}, {}
    for mode in ("vmap", "loop"):
        server = StereoServer(cfg, batch_mode=mode, auto_capacity=False, device=dev)
        _, per_batch[mode] = _launches(lambda: server(lb, rb))
        stats[mode] = server.throughput(lb, rb, reps=args.reps)["frames_per_s"]
    if per_batch["vmap"] != per_batch["loop"]:
        raise RuntimeError(f"the batch modes launched {per_batch}")
    best = max(stats, key=lambda k: (stats[k] == stats[k]) and stats[k])  # NaN loses
    return {"config": "serving_batched", "metric": "frames_per_s", "value": stats[best],
            "unit": f"frames/s/chip (B={B}, {left.shape[0]}x{left.shape[1]}, L=16, {best} "
                    "batch mode; 'vmap' runs the per-frame program, as 'loop' does)",
            "loop_fps": stats["loop"], "vmap_fps": stats["vmap"], "device": device_name(dev),
            "launches_per_call": per_batch["loop"]}


RUNNERS = {"tsukuba_dense": _tsukuba_dense, "middlebury64": _middlebury64,
           "trainable_step": _trainable_step, "fullres128": _fullres128,
           "serving_batched": _serving_batched}
CONFIGS = tuple(RUNNERS)  # the JAX suite's order: --configs' indices count in it


def run_config(name: str, args: argparse.Namespace, device) -> dict:
    """The JSON line of configuration `name` (floats rounded to 3 places,
    as the JAX suite rounds them)."""
    res = RUNNERS[name](args, resolve_device(device))
    return {k: round(v, 3) if isinstance(v, float) else v for k, v in res.items()}


def main(argv=None) -> list[dict]:
    """Run `argv`'s configurations in order; print and return their lines."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    lines = []
    for name in _config_names(args.configs):
        res = run_config(name, args, dev)
        print(json.dumps(res), flush=True)
        lines.append(res)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return lines


if __name__ == "__main__":
    main()
