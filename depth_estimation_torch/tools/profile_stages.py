"""Per-stage timing of the CRF stereo pipeline (counterpart of the JAX
system's `tools/profile_stages.py`).

Times each lattice stage of one configuration: one mean-field update with
the lattice filter (`update`) and without it (`elemwise`), the simplex
embedding, the plan build, splat, blur, slice, the whole filter (`apply`),
the cost volume and the whole pipeline. Each stage runs as a chain of
steps timed by `utils.timing.loop_timer` (CUDA events on the GPU), each
step depending on the last through `jitter` and `scalarize`, so the times
are the stages' own with dispatch included.

    python -m depth_estimation_torch.tools.profile_stages [--device cpu]
        [--labels 16] [--reps 20] [--h 288 --w 384] [--tiled {0,1,2}]
        [--fused-update {0,1}] [--compute-dtype {f32,bf16}] [--pair pair.npz]
        [--stages splat,blur] [--out result.json]

`--pair` names a numpy .npz holding the pair to profile: `left` and
`right`, (h, w, 3) in [0, 1], and optionally the ground truth `disparity`,
(h, w) with 0 where unknown; h and w are then the pair's. Without it, the
pair at 288×384 is the Tsukuba pair where `DET_TSUKUBA_DIR` holds it, else
(and at every other size) uniform noise from `RandomState(0)`.
`--tiled` flattens the guide tile-major (h and w multiples of
`--tile-px`) and builds the tiled tables, in bf16 with `--tiled 2`.
`--fused-update 1` runs the pipeline stage with the fused mean-field
update (a CUDA kernel on the GPU, its plain version on the CPU) and adds
each kernel's launches per pipeline call to the JSON line;
`--compute-dtype bf16` runs the pipeline stage's mean-field state in
bfloat16. The JSON line also carries the plan's occupied vertices
(`num_valid`, over `capacity` where the lattice overflowed and the excess
was dropped) and, where the pair has a ground truth, the pipeline's EPE and
bad-2 on one untimed call. Prints one JSON line; writes it to `--out` only
where given.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from ..crf.compat import charbonnier2, compatibility_matrix
from ..crf.guides import stack_guide
from ..data.datasets import TsukubaPair
from ..models.pipeline import CRFStereoConfig, blocked, crf_stereo_infer
from ..ops import permutohedral as P
from ..ops.costvolume import cost_volume
from ..ops.cuda import meanfield as K
from ..train.metrics import bad_pixel_ratio, epe
from ..utils.device import resolve_device
from ..utils.timing import jitter, loop_timer, scalarize

__all__ = ["STAGES", "StageInputs", "parse_args", "load_pair", "prepare", "make_stages",
           "main"]

STAGES = ("update", "elemwise", "embed", "plan", "splat", "blur", "slice", "apply",
          "costvolume", "pipeline")
FLAGSHIP = (288, 384)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--labels", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--h", type=int, default=288)
    ap.add_argument("--w", type=int, default=384)
    ap.add_argument("--max-vertices", type=int, default=None,
                    help="static capacity (default: 16384 at 288x384, else the "
                         "measured occupancy x3)")
    ap.add_argument("--order-by-sum", type=int, default=0, choices=(0, 1))
    ap.add_argument("--tiled", type=int, default=0, choices=(0, 1, 2),
                    help="tiled splat/slice; 2 = bfloat16 blocks")
    ap.add_argument("--tile-px", type=int, default=32,
                    help="image-block edge for the tiled tables")
    ap.add_argument("--tile-u", type=int, default=None,
                    help="per-tile vertex capacity (default: by --tile-px at 288x384, "
                         "else 512)")
    ap.add_argument("--sort-mode", default="auto",
                    help="plan sort strategy (auto|packed1|packed2|lex)")
    ap.add_argument("--stages", default=None,
                    help="comma list to restrict (" + ",".join(STAGES) + ")")
    ap.add_argument("--fused-update", type=int, default=0, choices=(0, 1),
                    help="the pipeline stage takes the fused mean-field update")
    ap.add_argument("--compute-dtype", default="f32", choices=("f32", "bf16"),
                    help="the pipeline stage's mean-field state")
    ap.add_argument("--pair", default=None,
                    help=".npz with left, right (h, w, 3) and optionally disparity (h, w)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    return ap.parse_args(argv)


def load_pair(h: int, w: int, device, path: str | None = None):
    """(left, right, ground truth or None, what the pair is): the pair in
    the .npz at `path`, else the Tsukuba pair at 288×384 where it is
    present, else uniform noise from `RandomState(0)`; (h, w, 3) and
    (h, w) float32 tensors on `device`."""
    gt = None
    if path is not None:
        with np.load(path) as f:
            left, right = f["left"], f["right"]
            gt = f["disparity"] if "disparity" in f.files else None
        source = path
    elif TsukubaPair().available() and (h, w) == FLAGSHIP:
        item = TsukubaPair().load()
        left, right, gt = item["left"], item["right"], item["disparity"]
        source = "tsukuba"
    else:
        rng = np.random.RandomState(0)
        left, right = rng.rand(h, w, 3), rng.rand(h, w, 3)
        source = "noise"

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return t(left), t(right), None if gt is None else t(gt), source


@dataclass
class StageInputs:
    """What the stages run on: the pair and its ground truth (or None), the
    config, the (tile-major when tiled) guide `ref`, the plan builder and
    its plan, and the stage inputs `src` (n, L), `vals` (its splat),
    `blurred`, `E0f`, `Q0`, `Mu`."""

    left: torch.Tensor
    right: torch.Tensor
    gt: torch.Tensor | None
    cfg: CRFStereoConfig
    ref: torch.Tensor
    build: Callable[[torch.Tensor], P.PermutohedralPlan]
    plan: P.PermutohedralPlan
    src: torch.Tensor
    vals: torch.Tensor
    blurred: torch.Tensor
    E0f: torch.Tensor
    Q0: torch.Tensor
    Mu: torch.Tensor


def prepare(args: argparse.Namespace, device) -> tuple[StageInputs, dict]:
    """The stage inputs of `args` on `device`, and the JSON line's
    configuration keys (capacity, tiling, sort mode, the pair, the
    plan's occupancy)."""
    left, right, gt, source = load_pair(args.h, args.w, device, args.pair)
    (h, w), L = left.shape[:2], args.labels
    B = args.tile_px
    if args.tiled and (h % B or w % B):
        raise ValueError(f"--tiled needs h and w to be multiples of --tile-px {B}; "
                         f"{h}x{w} is not (run it untiled)")
    tile_u = args.tile_u
    if tile_u is None:
        tile_u = {8: 256, 16: 384, 32: 512}.get(B, 512) if (h, w) == FLAGSHIP else 512
    tile_kw = dict(tile_px=B, tile_u=tile_u, tile_bf16=args.tiled == 2) if args.tiled else {}
    cfg0 = CRFStereoConfig(num_disp=L, niters=5, backend="lattice",
                           order_by_sum=bool(args.order_by_sum), sort_mode=args.sort_mode,
                           fused_update=bool(args.fused_update),
                           compute_dtype=args.compute_dtype, **tile_kw)
    guide = stack_guide(left, cfg0.sigma_color, cfg0.sigma_pos)
    ref = blocked(guide, B) if args.tiled else guide.reshape(h * w, -1)
    if args.max_vertices:
        cap = args.max_vertices
    elif (h, w) == FLAGSHIP and args.pair is None:
        cap = 16384  # the flagship's occupancy (~4.7k on Tsukuba) x3, a power of 2
    else:
        cap = P.suggest_capacity(ref, headroom=3.0)
    cfg = replace(cfg0, max_vertices=cap)

    def build(r: torch.Tensor) -> P.PermutohedralPlan:
        return P.build_plan(r, max_vertices=cap, order_by_sum=bool(args.order_by_sum),
                            tile=B * B if args.tiled else None, tile_u=tile_u,
                            tile_bf16=args.tiled == 2, sort_mode=args.sort_mode)

    plan = build(ref)
    src = torch.as_tensor(np.random.RandomState(1).rand(h * w, L), dtype=torch.float32,
                          device=device)
    vals = P._splat(plan, src)
    blurred = P._blur(plan, vals, False)
    Mu = compatibility_matrix(lambda a, b: charbonnier2(a, b, cfg.gamma),
                              torch.arange(L, dtype=torch.float32, device=device))
    E0f = torch.as_tensor(np.random.RandomState(2).rand(h * w, L), dtype=torch.float32,
                          device=device) * 10.0
    Q0 = torch.softmax(-E0f, dim=-1)
    inputs = StageInputs(left, right, gt, cfg, ref, build, plan, src, vals, blurred, E0f, Q0, Mu)
    # max_pieces: the JAX tool's key; the port has no piece splat
    keys = {"capacity": int(cap), "max_pieces": None, "tiled": args.tiled,
            "tile_px": B if args.tiled else None, "tile_u": tile_u if args.tiled else None,
            "sort_mode": args.sort_mode, "order_by_sum": bool(args.order_by_sum),
            "pair": source, "h": h, "w": w, "compute_dtype": args.compute_dtype,
            "num_valid": int(plan.num_valid),
            "tile_overflow": None if plan.tile_overflow is None else int(plan.tile_overflow)}
    return inputs, keys


def make_stages(s: StageInputs) -> dict[str, Callable[[torch.Tensor], object]]:
    """{stage: fn(acc) -> the stage's output}, each fn doing the stage's
    work on inputs jittered by the scalar `acc`. `update` is one mean-field
    update in isolation and `elemwise` its skeleton with the filter
    replaced by the identity: their gap is the filter's cost inside the
    loop."""
    plan, cfg = s.plan, s.cfg
    dev = s.left.device

    def update(a, filt):
        Qj = jitter(s.Q0, a)
        msg = filt(Qj @ s.Mu)
        return torch.softmax(-(s.E0f + msg - Qj @ s.Mu), dim=-1)

    return {
        "update": lambda a: update(a, lambda x: P.apply_plan(plan, x)),
        "elemwise": lambda a: update(a, lambda x: x),
        "embed": lambda a: P._simplex_embed_cols(jitter(s.ref, a)),
        "plan": lambda a: s.build(jitter(s.ref, a)),
        "splat": lambda a: P._splat(plan, jitter(s.src, a)),
        "blur": lambda a: P._blur(plan, jitter(s.vals, a), False),
        "slice": lambda a: P._slice(plan, jitter(s.blurred, a)),
        "apply": lambda a: P.apply_plan(plan, jitter(s.src, a)),
        "costvolume": lambda a: cost_volume(jitter(s.left, a), s.right, cfg.num_disp,
                                            cfg.window_size),
        "pipeline": lambda a: crf_stereo_infer(jitter(s.left, a), s.right, cfg,
                                               device=dev)["disparity"],
    }


def main(argv=None) -> dict:
    """Time the stages of `argv`'s configuration; print and return the
    JSON line ({stage}_ms in milliseconds; with --fused-update 1 the
    kernels' launches per pipeline call; with a ground truth the pipeline's
    EPE and bad-2)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    inputs, results = prepare(args, dev)
    results = {"device": str(dev), **results}
    want = set(args.stages.split(",")) if args.stages else None
    for name, fn in make_stages(inputs).items():
        if want is not None and name not in want:
            continue
        calls = [0]

        def body(a, fn=fn):
            calls[0] += 1
            return a + scalarize(fn(a))

        before = K.launch_counts()
        results[f"{name}_ms"] = loop_timer(body, reps=args.reps, device=dev) * 1e3
        if name == "pipeline" and args.fused_update:
            after = K.launch_counts()
            results["fused_update"] = True
            results["pipeline_launches_per_call"] = {k: (after[k] - before[k]) / calls[0]
                                                     for k in after}
    if inputs.gt is not None and (want is None or "pipeline" in want):
        disp = crf_stereo_infer(inputs.left, inputs.right, inputs.cfg, device=dev)["disparity"]
        mask = (inputs.gt > 0).float()
        results["pipeline_epe"] = float(epe(disp, inputs.gt, mask))
        results["pipeline_bad2"] = float(bad_pixel_ratio(disp, inputs.gt, 2.0, mask))
    line = json.dumps(results)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return results


if __name__ == "__main__":
    main()
