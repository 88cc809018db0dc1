#!/usr/bin/env python3
"""The benchmark line of the PyTorch port (counterpart of the JAX system's
`bench.py`): mean-field CRF iterations per second of the flagship stereo
pipeline on one GPU, printed as one JSON line in `bench.py`'s schema.

The flagship: a 288×384 pair (the Tsukuba pair where `DET_TSUKUBA_DIR`
holds it, else uniform noise from `RandomState(0)`; `--pair` names an .npz
with `left` and `right`, (h, w, 3) in [0, 1], whose size then replaces
--h and --w), 16 labels, the 5-D bilateral guide and 5 mean-field
iterations, in `bench.py`'s default configuration: the capacity calibrated
on the left image (`pipeline.calibrate_capacity`, headroom 3), 32-px tiles
with bf16 incidence blocks, bf16 mean-field state and the fused update (K1,
5 launches a pipeline call).

- `pipeline_ms`: one pipeline call by `utils.timing.loop_timer` (CUDA
  events around a chain of calls, each on the left image jittered by the
  chain's scalar, differenced against a chain of one);
- `iter_ms`: the pipeline at niters + 4 iterations less the pipeline at
  niters, over 4: one iteration at steady state, without the cost volume
  and the plan;
- `roofline_fraction`: `iteration_traffic_bytes` over `iter_ms`, against
  the H100's 3.35 TB/s (`utils.profiling.roofline`);
- `vs_baseline`: with `--dense-baseline`, the dense O(n²) oracle's pipeline
  time over the lattice's, both measured in this run on the same device;
  else 1.0, with `vs_baseline_source` null.

One process calibrates, times and prints, and a failure raises. The
fused-update kernels' launches in one pipeline call and the plan's
occupancy go to standard error as one JSON object.

    python bench_torch.py [--device cuda|cpu] [--labels 16] [--niters 5]
        [--h 288 --w 384] [--reps 10] [--pair pair.npz] [--dense-baseline]
        [--headroom 3] [--order-by-sum {0,1}]
        [--tiled {0,1,2}] [--tile-px 32] [--fused {0,1}] [--dtype {f32,bf16}]
        [--sort-mode auto|packed1|packed2|lex]
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

import torch

from depth_estimation_torch.models.pipeline import (CRFStereoConfig, calibrate_capacity,
                                                    crf_stereo_infer)
from depth_estimation_torch.ops.cuda import meanfield as K
from depth_estimation_torch.tools.bench_suite import device_name
from depth_estimation_torch.tools.profile_stages import load_pair
from depth_estimation_torch.utils.device import resolve_device
from depth_estimation_torch.utils.profiling import roofline
from depth_estimation_torch.utils.timing import jitter, loop_timer

EXTRA_ITERS = 4  # iter_ms differences the pipeline at niters + 4 and at niters
GUIDE_DIMS = 5  # the bilateral guide: rgb and the two pixel coordinates


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--labels", type=int, default=16)
    ap.add_argument("--niters", type=int, default=5)
    ap.add_argument("--h", type=int, default=288)
    ap.add_argument("--w", type=int, default=384)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--headroom", type=float, default=3.0,
                    help="capacity headroom over the measured lattice occupancy")
    ap.add_argument("--order-by-sum", type=int, default=0, choices=(0, 1),
                    help="prepend the coordinate-sum column to the plan's sorts")
    ap.add_argument("--tiled", type=int, default=2, choices=(0, 1, 2),
                    help="tiled splat/slice (--tile-px image blocks, dense per-tile "
                         "incidence products); 2 = bfloat16 blocks")
    ap.add_argument("--fused", type=int, default=1, choices=(0, 1),
                    help="the fused mean-field update (a CUDA kernel on the GPU)")
    ap.add_argument("--dtype", default="bf16", choices=("f32", "bf16"),
                    help="mean-field state dtype")
    ap.add_argument("--sort-mode", default=None,
                    help="override the calibrated plan sort strategy (auto|packed1|packed2|lex)")
    ap.add_argument("--tile-px", type=int, default=32, help="tiled image-block edge in pixels")
    ap.add_argument("--dense-baseline", action="store_true",
                    help="measure the dense O(n^2) oracle in this run for vs_baseline")
    ap.add_argument("--pair", default=None,
                    help=".npz with left and right (h, w, 3) to run instead of the flagship pair")
    return ap.parse_args(argv)


def iteration_traffic_bytes(h: int, w: int, L: int, d: int, C: int) -> int:
    """The bytes one mean-field iteration must move at the least, in
    float32, as `bench.py` counts them: the softmax and the Mu product,
    the splat (a gather of the n(d+1) entries' values and their metadata,
    one write of the C vertices), d+1 blur passes (two gathers, a read and
    a write of the vertices each), the slice (gathers and a write) and the
    energy update. Padding and waste of an implementation are not counted.
    h×w pixels, L labels, a d-dimensional guide, C lattice vertices."""
    n = h * w
    N = n * (d + 1)
    f = 4
    return (2 * n * L * f  # softmax read + write
            + 2 * n * L * f  # Mu product
            + (N * L + N * 2 + C * L) * f  # splat: gather + entry metadata + vertex write
            + (d + 1) * 4 * C * L * f  # blur: 2 gathers + read + write an axis
            + ((d + 1) * n * L + n * (d + 1) * 2 + n * L) * f  # slice
            + 3 * n * L * f)  # message subtract, E0 add, write


def bench_config(args: argparse.Namespace, left: torch.Tensor, dev) -> CRFStereoConfig:
    """`args`' configuration, its capacity, tiles and sort mode calibrated
    on `left` as `bench.py` calibrates them."""
    cfg = CRFStereoConfig(num_disp=args.labels, niters=args.niters, backend="lattice",
                          order_by_sum=bool(args.order_by_sum))
    cfg = calibrate_capacity(left, cfg, headroom=args.headroom, tiled=bool(args.tiled),
                             tile_px=args.tile_px, device=dev)
    return replace(cfg, tile_bf16=args.tiled == 2, sort_mode=args.sort_mode or cfg.sort_mode,
                   compute_dtype=args.dtype, fused_update=bool(args.fused))


def main(argv=None) -> dict:
    """Calibrate, time and print `argv`'s benchmark line; returns it."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    left, right, _, _ = load_pair(args.h, args.w, dev, args.pair)
    h, w = left.shape[:2]
    cfg = bench_config(args, left, dev)

    def pipeline(c):
        def body(a):
            out = crf_stereo_infer(jitter(left, a), right, c, device=dev)["disparity"]
            return a + out.sum(dtype=torch.float32)

        return body

    before = K.launch_counts()
    plan = crf_stereo_infer(left, right, cfg, device=dev)["plans"][0]
    after = K.launch_counts()
    print(json.dumps({"launches_per_call": {k: after[k] - before[k] for k in after},
                      "num_valid": int(plan.num_valid),
                      "tile_overflow": None if plan.tile_overflow is None
                      else int(plan.tile_overflow)}), file=sys.stderr, flush=True)
    del plan

    dt = loop_timer(pipeline(cfg), reps=args.reps, device=dev)
    iters_per_s = args.niters / dt
    iter_ms = roofline_fraction = None
    if args.niters > 1:
        dtn = loop_timer(pipeline(replace(cfg, niters=args.niters + EXTRA_ITERS)),
                         reps=args.reps, device=dev)
        iter_s = max(dtn - dt, 1e-9) / EXTRA_ITERS
        iter_ms = iter_s * 1e3
        if iter_ms < 1e-3:  # noise swamped the difference
            iter_ms = None
        else:
            traffic = iteration_traffic_bytes(h, w, args.labels, GUIDE_DIMS, cfg.max_vertices)
            roofline_fraction = roofline(iter_s, traffic)["hbm_fraction"]

    vs_baseline = vs_source = None
    if args.dense_baseline:
        dense = CRFStereoConfig(num_disp=args.labels, niters=args.niters, backend="dense")
        vs_baseline = loop_timer(pipeline(dense), reps=3, device=dev) / dt
        vs_source = "dense oracle measured live"

    result = {
        "metric": "crf_meanfield_iters_per_s",
        "value": round(iters_per_s, 3),
        "unit": f"iters/s/chip ({h}x{w}px, L={args.labels}, d=5 bilateral)",
        "vs_baseline": round(vs_baseline, 3) if vs_baseline else 1.0,
        "detail": {
            "pipeline_ms": round(dt * 1e3, 3),
            "iter_ms": round(iter_ms, 3) if iter_ms else None,
            "roofline_fraction": round(roofline_fraction, 4) if roofline_fraction else None,
            "device": device_name(dev),
            "niters": args.niters,
            "max_vertices": cfg.max_vertices,
            "max_pieces": None,  # bench.py's key: the port has no piece splat
            "order_by_sum": cfg.order_by_sum,
            "tile_px": cfg.tile_px,
            "tile_u": cfg.tile_u if cfg.tile_px else None,
            "sort_mode": cfg.sort_mode,
            "unroll": None,  # bench.py's key: an eager loop has nothing to unroll
            "vs_baseline_source": vs_source,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
