#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`depth_estimation_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's flagship stereo inference, `crf_stereo_infer` on a
288×384 pair with 16 labels, a 5-D bilateral guide and 5 mean-field
iterations, through both lattice plan paths, then its training path, its
serving, multi-device, operator and detection paths, fullres128, a
wide-disparity frame, the route above 1024 labels, the tools' entry
points and the benchmark programs:

  A. the bench configuration: calibrated capacity, 32-px tiles with bf16
     incidence blocks, bf16 mean-field state and the fused update, on a
     synthetic pair at contrast 0.5, whose calibration pins 'packed1' and so
     takes the lean per-tile plan;
  B. the same pair at full contrast, whose calibration keeps 'auto' and so
     takes the general plan with tiled tables, in float32 with the fused
     update;
  C. one training step of the CRF-as-RNN layer (`CRFasRNN`, lattice
     backend, trainable 5-D guide, 5 iterations) on A's pair: forward,
     backward through the lattice (∂src and the 4-filter ∂ref) and an Adam
     step, with the plan calibrated as the JAX package's `trainable_step`
     (capacity at headroom 8, 32-px tiles, bf16 incidence blocks, tile_u
     at headroom 2, the suggested sort mode); its first step is held
     against the port's CPU run of the same step, then timed and profiled;
  D. three steps of `train_tsukuba_crf` (random guidance, an 8-D guide,
     the general untiled plan at the default capacity) on B's pair;
  F. `StereoServer` in A's configuration on 8 pairs (pair i from
     `RandomState(i)`, contrast 0.5), calibrated on the first frame: each
     frame against `crf_stereo_infer` with the server's config, vmap mode
     against loop mode, 40 launches of the fused update a batch,
     `throughput()` and one profiled batch;
  G. the distributed code on the one card: a 2-rank probe of whether
     gloo's point-to-point ops take CUDA tensors (reported, not gated), then
     a world of 4 ranks on cuda:0 under 'gloo' (NCCL refuses two ranks on
     one GPU): the halo exchange of a CUDA tensor against slicing, the
     4-stripe `crf_stereo_infer_tiled` (halo 48) on the card against the
     same world's CPU run (5e-3 px), and one `Trainer(mesh=...)` step of
     `CRFasRNN` (float32 blocks, one pair a rank) whose all-reduced
     gradients are held against rank 0's single-process full batch; the
     timings of a world that shares one card are no scaling numbers;
  H. the remaining operators on A's pair, each against the port's CPU run:
     the spectral embedding and `spectral_segment` (eigenvalues to 1e-3,
     residuals under the solver's own convergence bound, at least 2
     segments), `cg_refine_bilateral` of the unary disparity (1e-4),
     `lsh_gaussian_filter` of the unary probabilities over the flagship
     guide (1e-5) and `composite_mask_depth` of the 3 ground-truth layers
     (exact);
  I. detection inference at full width: `MaskRCNN()` at its defaults (81
     classes, ResNet-50 with GroupNorm, FPN 256, 256 proposals, 64
     detections, random weights from a seeded generator) on one 800×1024
     shapes image: the first call, the warm call (median of 10, CUDA
     events) and one profile; then every stage against the port's CPU run
     on the card's input to that stage (pyramid, RPN logits and deltas,
     box-head scores and deltas, mask logits to 1e-3 of the CPU's scale;
     the proposal and detection picks in order until the first rounding
     flip, a score gap or an IoU's distance from the NMS threshold under
     1e-4); and one `detect_augmented` with hflip;
  J. detection training at the width of the repo's recorded run
     (DETECT_SCALED.json: blocks (2, 2, 2, 2), FPN 128) on 128×128 shapes
     with masks: the first step on the card against the CPU given the
     card's proposals, its loss in float32 and float64 to 1e-4, and the
     card's float64 and float32 gradients against the CPU's float64 ones
     to C's tolerances (the CPU's own float32 backward is percents off its
     float64 one, so the float32 runs of card and CPU are compared only in
     print), 2 warm-up and 10 timed float32 Adam steps, one profile,
     `evaluate_detection` on 4 held-out items (mAP printed, not gated:
     random init) and 3 steps of `train_detection_shapes`;
  K. the repo's largest configuration, fullres128: a 1088×1920 synthetic
     pair (6 layers, disparities to 96), 128 labels, 5 iterations,
     calibrated as the bench calibrates it, bf16 state and the fused update,
     so the update runs on K1w: 5 K1w launches and no K1 launch, a finite
     disparity; under deterministic algorithms the same run with K1w's
     plain version in its place within 0.1 px (mean) and, in float32, the
     unfused loop within 5e-3 px; its 192×256 crop in float32 against the
     port's CPU run (5e-3 px); a repeat of the run and the unfused bf16
     loop are printed (the bf16 state is noise-bound at 128 labels), as
     are the calibration, the warm pipeline (median of 3), one profile and
     the peak device memory;
  L. wide disparities: a 994x1482 synthetic pair (tools/bench_suite.py's
     middlebury64 size; 6 layers, disparities to 318) at 320 labels, the
     range of a half-size Middlebury 2014 frame, calibrated, bf16 and fused
     as K: 5 K1x launches and no other kernel's, a finite disparity; under
     deterministic algorithms the same run with K1x's plain version in its
     place within 0.1 px (mean) and, in float32, the unfused loop within
     5e-3 px; its 96x384 crop (wider than L) in float32 against the port's
     CPU run (5e-3 px); the calibration, the warm pipeline (median of 3),
     one profile and the peak device memory are printed;
  M. K1xx's route inside the pipeline, a check of the route and not a
     user's configuration (no configuration of the repo has more than 1024
     labels): a 160x1280 synthetic pair (6 layers, disparities to 1098) at
     1100 labels, calibrated, bf16 and fused as L: 5 K1xx launches and no
     other kernel's, a finite disparity; under deterministic algorithms the
     same run with K1xx's plain version in its place within 0.1 px (mean)
     and, in float32, the unfused loop within 5e-3 px; printed beside that
     bf16 gate, what rounding alone does to it: the share of C' values
     that K1xx rounds otherwise than its plain version in the run, the
     plain version with that share of its C' values moved by one bf16 ulp
     (two seeds), and with C' summed in float64 and rounded once; the warm
     pipeline (median of 3), K1xx's share of one profile and the peak device
     memory;
  N. the entry points of `depth_estimation_torch.tools`, called as a user
     calls them: `profile_stages --fused-update 1 --pair` on A's, K's and
     L's own pairs (saved to a temporary .npz) with their phases'
     calibrated capacity, sort mode, tiles and bf16 state passed as flags:
     every stage's time finite and positive, the tool's configuration the
     phase's with no vertex dropped, K1, K1w and K1x 5 times a pipeline
     call, and the tool's pipeline EPE within 0.1 px of the same config's
     direct run; `tiled_stereo_study --mode time` at 994x1482, 64 labels,
     on a one-rank world (the one-tile map at halo 0 within 5e-3 px of the
     untiled one, both in deterministic mode; at halo 16 within 1e-4 px
     mean of the same call on the CPU, and within 5e-3 px max plus what one
     float32 rounding of the left image moves the CPU's map; the zero rows
     padded at the frame's edges move the halo-16 map off the untiled one,
     printed);
     `train_detect_scaled --steps 96` (finite losses, the grafted body
     bit-equal after the heads phase, every parameter moved by the
     all-layers phase; the median step after each phase's first 16) and
     `train_coco_scaled --steps 48 --items 8` (the tree reads back as 8
     items, finite losses). Their JSON lines go to chiprun_out/.
  O. the benchmark programs, each the counterpart of a JAX system's
     program: `bench_torch.py --reps 10` in a process of its own, on its
     defaults and on A's pair (`--pair`, with `--dense-baseline`), whose
     calibration must be A's: `bench.py`'s keys, the card's name, a
     roofline fraction in (0, 1], K1 5 times a pipeline call, no vertex
     dropped; the five configurations of `tools.bench_suite` at full size
     (the JAX suite's keys; K1 5 times a call in middlebury64, K1w 5 in
     fullres128, K1 40 a batch in serving_batched, none in tsukuba_dense
     and trainable_step; no vertex dropped): tsukuba_dense's float32 map
     (TF32 off) against the same pipeline in float64 within 5e-3 px plus
     what one float32 rounding of the left image moves it, middlebury64's
     bf16 map against K1's plain version in its place within 0.1 px mean
     (deterministic mode), fullres128's pipeline within 10% of K's warm
     run; and `tools.bench_scaling` on the card present (size 1 on one
     card, its note saying so). Their JSON lines go beside N's.

It builds the CUDA kernels from `depth_estimation_torch/csrc` and the C++
CPU lattice (one compiler per source, all at once), prints what `ptxas`
reports for every kernel instantiation (registers, shared memory, spills;
more registers than the kernel's own __launch_bounds__ allow, or any spill,
fails), holds each kernel against its plain PyTorch version on the card
(K1 at 8 to 64 labels; K1w, the tensor-core kernel, at 3, 12, 24, 100, 128
and 256 labels, at the edges of its padded widths and at fullres128's
shape; K1x at 257, 288, 300, 320, 384, 512, 1000 and 1024 labels; K1xx,
which serves every L above 1024, at 1025, 1088, 1100, 1536, 2048 and 4099
and at phase M's shape; the lattice apply's slice bit for bit and splat within a
bf16 rounding at fullres128's shape, (2088960, 128) bf16 through K's frame's
plan of 131072 slots, and K's run launches each 5 times; the stereo cost
volume at K's and L's frames against float64 and its plain version) and
times them
(the lattice kernels there beside their byte bounds; K1 also at phase L's rows with 64
labels; K1w at fullres128's rows with 24, 128 and 256 labels; K1x also at
fullres128's rows with 256 labels; K1xx at (393216, 1536) and at phase L's
shape), counts the kernels' launches in
every phase (A, B and F launch K1 5 times a frame, K launches K1w 5
times, L K1x 5 times, M K1xx 5 times, N's three stage splits K1, K1w and
K1x 5 times a pipeline call, O's bench and middlebury64 K1 5 times a
call, its fullres128 K1w 5 times, its serving_batched K1 40 times a batch,
the others launch none of them),
and checks each
pipeline's disparity against the same pipeline without the kernel on the
card and against the port's own CPU run (the path the CPU tests hold
against the JAX package). Any failed check raises. The last lines are the
card's name and power limit, one JSON object of kernel numbers, and
`{"ok": true, "device": {...}}`. Without a GPU, or
without the package beside it, the script fails before printing a result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

H, W, LABELS, NITERS, TILE_PX = 288, 384, 16, 5, 32
DEV = "cuda"
# published peaks of one H100 SXM: memory bytes/s, float32 (non-tensor-core)
# FLOP/s, dense bf16 tensor-core FLOP/s
PEAK_BYTES_S, PEAK_F32_FLOP_S, PEAK_BF16_TC_FLOP_S = 3.35e12, 67e12, 989e12
F32_TOL = dict(rtol=1e-5, atol=1e-5)
SM_REGISTERS = 65536  # 32-bit registers of an SM, shared by its resident blocks
DISP_ATOL = 5e-3  # px: the tolerance of the JAX package's fused-update test
BF16_MEAN_TOL = 0.1  # px: mean |Δdisparity| where the two sides round in bf16
# px: mean |Δdisparity| of two float32 maps of a full frame; at 994x1482,
# L = 64 the card's and the CPU's, two card runs and the CPU's map with its
# input one rounding off differ by 5-7e-6 px mean, while their max (up to
# 0.008 px at a few pixels) exceeds DISP_ATOL (N4)
F32_MEAN_TOL = 1e-4
# C's first step, card against CPU, as fractions of the CPU's magnitude. The
# loss, and the loss and every gradient of the same step with float32
# incidence blocks: f32 sums taken in another order. The gradients with
# bf16 blocks are not held to the CPU run: ∂ref is a difference of large
# filtered terms whose inputs the bf16 blocks round to 2^-8, so a one-ulp
# difference in an upstream gradient flips roundings that the cancellation
# magnifies (the card's own repeated runs differ, its index_add_ adding in
# no fixed order). They are printed beside the float32-block gradients and
# must have their signs for the guide scales: at 96×128 on the CPU they
# were 35% and 62% off them.
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-4, 1e-3
# plus an absolute floor for the float32-block gradients: d/d log_s (about
# 0.01) is a sum that cancels, and two card runs of it differ by ~6e-6
STEP_GRAD_ATOL = 1e-4
SERVE_BATCH = 8  # F: pairs a batch
# G: ranks sharing cuda:0, their backend (NCCL refuses two ranks on one GPU),
# the tiled stereo's halo (about σp·diag = 0.1·480 px) and the pairs of the
# data-parallel step (one a rank)
WORLD, WORLD_BACKEND, TILED_HALO, DP_PAIRS = 4, "gloo", 48, 4
# H: the operators on the card against their CPU run, max |difference| over
# max |CPU|: CG's 30 float32 iterations sum in another order; the LSH
# filter's candidates are the same (float64 hashes) and only its weights round
CG_RTOL, LSH_RTOL = 1e-4, 1e-5
# H: a returned eigenpair's residual may exceed the solver's own convergence
# bound, recomputed here from the returned vectors, by this factor of rounding
CONVERGED_SLACK = 1.1
# I: `MaskRCNN()` at its defaults on one image at Detectron's 800-pixel test
# scale. Each stage on the card against the port's CPU run of that stage on
# the card's input to it: max |difference| over max |CPU| (float32 sums in
# another order, through up to 50 conv+GN layers), and in box coordinates
DET_H, DET_W = 800, 1024
DET_RTOL, DET_BOX_ATOL = 1e-3, 0.05
# I: a ranked pick (a proposal, a detection) may differ from the CPU's only
# where a rounding can flip it: a score gap, or an IoU's distance from the
# NMS threshold, under this
DET_FLIP_TOL = 1e-4
# J: training at the width of the repo's recorded detection run
# (DETECT_SCALED.json) on 128×128 shapes images with masks, 4 held out
J_SIZE, J_ITEMS, J_HOLDOUT = 128, 8, 4
J_MODEL = dict(num_classes=4, blocks=(2, 2, 2, 2), fpn_dim=128, num_proposals=32,
               num_detections=8, score_thresh=-1.0)
# K: the repo's largest configuration, fullres128 (tools/bench_suite.py:
# 1088×1920, 128 labels, 5 iterations, the 6-layer synthetic pair it takes
# without a Middlebury pair), calibrated as the suite calibrates it
# (`tools.bench_suite.lattice_cfg`); its 192×256 crop against the port's CPU
# run in float32
FULL_H, FULL_W, FULL_LABELS, FULL_MAX_DISP = 1088, 1920, 128, 96
# the lattice capacity K's calibration gives its frame (headroom 3), at which
# the lattice apply's kernels are timed
FULL_CAPACITY = 131072
CROP_H, CROP_W = 192, 256
# the label counts at which K1w is held against its plain version, and the
# edges of its padded widths (32, 64, 128, 256) and of its limit; K1x's
# (XWIDE_MAX_L, 1024, is checked too); K1xx's, on the flagship's rows and
# 7 fewer, and at XXWIDE_ODD_L labels on as many rows
WIDE_CHECK_L = (3, 12, 24, 100, 128, 256)
WIDE_EDGE_L = (1, 17, 33, 65, 127, 129, 255)
XWIDE_CHECK_L = (257, 288, 300, 320, 384, 512, 1000)
XXWIDE_CHECK_L = (1025, 1088, 1100, 1536, 2048)
XXWIDE_ODD_L = 4099
# K1xx timed at a 512x768 frame's rows at 1536 labels, its plain version
# over XX_SLOW_REPS launches
XX_N, XX_LABELS, XX_SLOW_REPS = 512 * 768, 1536, 20
# L: wide disparities, a half-size Middlebury 2014 frame (tools/bench_suite.py's
# middlebury64 size, 994x1482) at the 320 labels that Jadeplant's ndisp=640
# becomes at half size; the 6-layer synthetic pair the bench takes without a
# Middlebury pair; calibrated as the bench calibrates; its 96x384 crop (wider
# than L) in float32 against the port's CPU run
MID_H, MID_W, MID_LABELS = 994, 1482, 320
MID_CROP_H, MID_CROP_W = 96, 384
# M: K1xx's route inside the pipeline (no configuration of the repo has more
# than 1024 labels, so this is a check of the route): a 160x1280 synthetic
# pair at 1100 labels, calibrated as L
ROUTE_H, ROUTE_W, ROUTE_LABELS = 160, 1280, 1100
# N: the tools' entry points. The per-stage profiler's reps at A's size and
# at K's and L's (its plan and pipeline stages take tens to hundreds of ms
# there), the detection runs' steps (half heads-only in N5), N6's items and
# held-out items, the first steps of a training phase left out of its
# steady step time; their JSON lines go to TOOLS_OUT
N1_REPS, N_WIDE_REPS = 10, 5
N5_STEPS, N6_STEPS, N6_ITEMS, N6_HOLDOUT, N_WARM_STEPS = 96, 48, 8, 2, 16
TOOLS_OUT = Path(__file__).resolve().parent / "chiprun_out"
ROOT = TOOLS_OUT.parent
# O: the benchmark programs. The keys of the JAX programs' lines
# (bench.py:381-407, tools/bench_suite.py:215-365, tools/bench_scaling.py:
# 104-117), which tests/test_torch_bench*.py read from their sources; the
# suite's fused-update launches a call (a call of serving_batched is a batch
# of 8), absent kernels none; the bench's reps
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "detail")
BENCH_DETAIL_KEYS = ("pipeline_ms", "iter_ms", "roofline_fraction", "device", "niters",
                     "max_vertices", "max_pieces", "order_by_sum", "tile_px", "tile_u",
                     "sort_mode", "unroll", "vs_baseline_source")
FRAME_KEYS = ("config", "metric", "value", "unit", "pipeline_ms", "source", "max_vertices",
              "device")
SUITE_KEYS = {
    "tsukuba_dense": ("config", "metric", "value", "unit", "h", "w", "labels", "niters", "device"),
    "middlebury64": FRAME_KEYS,
    "trainable_step": ("config", "metric", "value", "unit", "device"),
    "fullres128": FRAME_KEYS,
    "serving_batched": ("config", "metric", "value", "unit", "loop_fps", "vmap_fps", "device")}
SCALING_KEYS = ("metric", "unit", "device", "frames_per_s", "efficiency_vs_linear", "note")
SUITE_LAUNCHES = {"tsukuba_dense": {}, "middlebury64": {"K1": NITERS}, "trainable_step": {},
                  "fullres128": {"K1w": NITERS}, "serving_batched": {"K1": SERVE_BATCH * NITERS}}
BENCH_REPS, SUITE_REPS = 10, 5
# O: fullres128's pipeline in the suite against K's warm run in the same
# call, both by the suite's timer (a chain of calls, differenced), as a
# fraction (K moved by <= 3.1% between calls); a single call's CUDA events
# also hold the host's start of the call, ~12 ms of a ~104 ms frame since
# the lattice kernels
FULLRES_REL_TOL = 0.10


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """A failed check raises (and, unlike `assert`, also under `python -O`)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median device time of `fn` over `reps` runs, by CUDA events. With
    `flush`, a buffer larger than the L2 cache is rewritten before each run,
    so every run finds its inputs in device memory, not in L2."""
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def counters() -> dict:
    """The fused-update kernels' wrappers, by kernel name."""
    from depth_estimation_torch.ops.cuda import meanfield as K

    return K.KERNELS


def zero_launches() -> None:
    """Set the launch counts of the fused-update kernels (K1, K1w, K1x and
    K1xx) to 0."""
    from depth_estimation_torch.ops.cuda import meanfield as K

    K.zero_launch_counts()


def launches() -> dict:
    """Each fused-update kernel's launches since `zero_launches`."""
    from depth_estimation_torch.ops.cuda import meanfield as K

    return K.launch_counts()


def only_launched(name: str, want: int) -> int:
    """Check that `name` launched `want` times since `zero_launches` and no
    other fused-update kernel launched; returns its count."""
    got = launches()
    check(got == {k: want if k == name else 0 for k in got},
          f"launches {got}, want {want} of {name} and none of the others")
    return got[name]


def k1_launches() -> int:
    """K1's launches since `zero_launches`; a path at the repo's label
    counts of 8 to 64 must have launched K1w, K1x and K1xx no time."""
    wrappers = counters()
    for name in ("K1w", "K1x", "K1xx"):
        check(wrappers[name].launches == 0, f"{name} launched {wrappers[name].launches} times")
    return wrappers["K1"].launches


# ---------------------------------------------------------------------------
# the fused mean-field update against its plain version
# ---------------------------------------------------------------------------


def _ptxas(name: str, pattern: str) -> dict:
    """{groups of `pattern`: registers, static shared memory, stack and
    spills} for each kernel of csrc/<name>.cu whose mangled name matches
    `pattern`, from the build's `ptxas -v` log."""
    from depth_estimation_torch.utils.build import build_log

    found, cur = {}, None
    for line in build_log(name).splitlines():
        k = re.search(pattern, line)  # the mangled name opens an instantiation's lines
        if k:
            cur = found.setdefault(k.groups(), {})
        elif "Compiling entry function" in line or "Function properties for" in line:
            cur = None  # another kernel's lines (a source may hold several)
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(smem.group(1)) if smem else 0
    return found


def register_cap(threads: int, min_blocks: int) -> int:
    """The registers a thread may use under __launch_bounds__(threads,
    min_blocks): the SM's registers over the threads of min_blocks blocks,
    at most 255."""
    return min(255, SM_REGISTERS // (threads * min_blocks))


def ptxas_report(K) -> list[dict]:
    """Registers, static shared memory and spills of every instantiation of
    the fused update: K1 (<L, float or bfloat16>, __launch_bounds__(128,
    4)), K1w (<float or bfloat16, LP>, its bounds from `wide_config`), K1x
    (<float or bfloat16, rows a tile, values a lane>, (its threads, 1); and
    its Mu-tiling pass, no bounds), K1xx (<float or bfloat16>, (its
    threads, 1); and its Mu-tiling pass), the lattice apply's splat and slice (<float or double
    weights, float, bfloat16 or double values, 1 or 8 values a lane>, 256
    threads and 2 to 8 blocks an SM) and the cost volume (<1 to 4
    channels, window radius 0 to 8>, (256, 2) to r = 4, (256, 1) above),
    each held to its own register cap,
    with the dynamic shared
    memory of K1's launch at the flagship row count, of K1w's at
    fullres128's row count, of K1x's at phase L's and of K1xx's at its
    timed shape."""
    dtname = {"f": "f32", "13__nv_bfloat16": "bf16"}
    elts = {"f": 4, "13__nv_bfloat16": 2}
    n_full = FULL_H * FULL_W
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1 = _ptxas("meanfield", r"fused_energy_update_kernelILi(\d+)E(f|13__nv_bfloat16)E")
    k1w = _ptxas("meanfield_wide", r"fused_energy_update_wide_kernelI(f|13__nv_bfloat16)Li(\d+)E")
    k1x = _ptxas("meanfield_xwide",
                 r"fused_energy_update_xwide_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E")
    tile = _ptxas("meanfield_xwide",
                  r"fused_energy_update_xwide_tile_mu_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E")
    k1xx = _ptxas("meanfield_xxwide", r"fused_energy_update_xxwide_kernelI(f|13__nv_bfloat16)E")
    tile_xx = _ptxas("meanfield_xxwide",
                     r"fused_energy_update_xxwide_tile_mu_kernelI(f|13__nv_bfloat16)E")
    wanted = [("K1", f"L={L}", dtname[m], k1.get((str(L), m)),
               K.launch_geometry(H * W, L, elts[m]).smem_bytes, register_cap(128, 4))
              for L in K.SUPPORTED_L for m in dtname]
    for m in dtname:
        for lp in (32, 64, 128, 256):
            cfg = K.wide_config(elts[m], lp)
            wanted.append(("K1w", f"LP={lp}", dtname[m], k1w.get((m, str(lp))),
                           K.wide_geometry(n_full, lp, elts[m], sms).smem_bytes,
                           register_cap(cfg["warps"] * 32, cfg["min_blocks"])))
    for m in dtname:  # (rows a tile, values a lane) at an L that launches each
        for rows, per_lane, L in ((64, 10, 320), (32, 16, 512), (32, 32, 640), (16, 32, 1024)):
            g = K.xwide_geometry(MID_H * MID_W, L, elts[m], sms)
            check(g.rows == rows, f"K1x at L={L} {dtname[m]}: {g.rows} rows a tile, want {rows}")
            wanted.append(("K1x", f"R={rows} it={per_lane}", dtname[m],
                           k1x.get((m, str(rows), str(per_lane))), g.smem_bytes,
                           register_cap(g.threads, 1)))
        # its Mu-tiling pass: (labels, columns) a stage
        for kt, nc in ((32, 160), (32, 64)) if m != "f" else ((32, 64), (16, 64)):
            wanted.append(("K1x tile_mu", f"kKt={kt} kNc={nc}", dtname[m],
                           tile.get((m, str(kt), str(nc))), 0, 255))
    for m in dtname:  # one instantiation a dtype, and its Mu-tiling pass
        g = K.xxwide_geometry(XX_N, XX_LABELS, elts[m], sms)
        wanted.append(("K1xx", "any L", dtname[m], k1xx.get((m,)), g.smem_bytes,
                       register_cap(g.threads, 1)))
        wanted.append(("K1xx tile_mu", "any L", dtname[m], tile_xx.get((m,)), 0, 255))
    # the lattice apply's kernels: <weights, values, values a lane>, 256
    # threads and the blocks an SM of their `Blocks`
    lattice = _ptxas("lattice_apply",
                     r"lattice_(splat|slice)_kernelI(f|d)(f|d|13__nv_bfloat16)Li(\d)E")
    names = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}

    def lattice_blocks(kind, w, v):
        if kind == "splat":
            return 2 if "d" in (w, v) else 4
        return 4 if "d" in (w, v) else 6 if v == "f" else 8
    wanted += [(f"lattice {kind}", f"weights {names[w]} vec={vec}", names[v],
                lattice.get((kind, w, v, vec)), 0, register_cap(256, lattice_blocks(kind, w, v)))
               for kind in ("splat", "slice") for w in "fd" for v in ("f", "13__nv_bfloat16", "d")
               for vec in "18"]
    # the cost volume: <channels, window radius>, 1 or 3 channels and radii
    # 0 to 8, (256, 2) up to r = 4 and (256, 1) above, at fullres128's geometry
    from depth_estimation_torch.ops.cuda.costvolume import costvolume_geometry

    cv = _ptxas("costvolume", r"costvolume_reflect_kernelILi(\d)ELi(\d)E")
    check(sorted(cv) == [(str(c), str(r)) for c in (1, 3) for r in range(9)],
          f"costvolume instantiations {sorted(cv)}")
    wanted += [("costvolume", f"C={c} r={r}", "f32", cv.get((str(c), str(r))),
                costvolume_geometry(FULL_H, FULL_W, c, FULL_LABELS, 2 * r + 1)["smem"],
                register_cap(256, 2 if r <= 4 else 1))
               for c in (1, 3) for r in range(9)]
    rows = []
    for kernel, which, dt, r, dynamic, cap in wanted:
        check(r is not None and "registers" in r and "spill_stores" in r,
              f"ptxas reported nothing for {kernel} {which} {dt}")
        r = dict(kernel=kernel, instance=which, dtype=dt, **r, dynamic_smem=dynamic,
                 register_cap=cap)
        log(f"  ptxas {kernel} {which} {dt}: {r['registers']} registers (cap {cap}), "
            f"{r['static_smem']} B static + {r['dynamic_smem']} B dynamic shared memory, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads, "
            f"{r['stack']} B stack")
        check(r["registers"] <= cap, f"{kernel} {which} {dt}: over its cap of {cap} registers")
        check(r["spill_stores"] == r["spill_loads"] == 0, f"{kernel} {which} {dt}: register spills")
        rows.append(r)
    return rows


def kernel_inputs(n: int, L: int, dtype, seed: int = 0, on_device: bool = False):
    """E0, S, C and Mu from a seed: by numpy, or (`on_device`, for the
    fullres shapes) by a seeded generator on the card."""
    if on_device:
        g = torch.Generator(device=DEV).manual_seed(seed)
        return [(torch.rand(n, L, generator=g, device=DEV) * 10).to(dtype),
                torch.randn(n, L, generator=g, device=DEV).to(dtype),
                torch.rand(n, L, generator=g, device=DEV).to(dtype),
                torch.rand(L, L, generator=g, device=DEV).to(dtype)]
    rs = np.random.RandomState(seed)
    arrays = (rs.rand(n, L) * 10, rs.randn(n, L), rs.rand(n, L), rs.rand(L, L))
    return [torch.from_numpy(a.astype(np.float32)).to(DEV, dtype) for a in arrays]


def check_fused_update(K, n: int, L: int, dtype, on_device: bool = False,
                       kernel: str | None = None) -> float:
    """Kernel against plain version, with the kernel that `kernel_for(L)`
    names (or `kernel`, through its own wrapper) launched once; returns the
    largest |difference|."""
    args = kernel_inputs(n, L, dtype, on_device=on_device)
    wrappers = counters()
    want = kernel or K.kernel_for(L)
    before = {k: f.launches for k, f in wrappers.items()}
    E_k, C_k = (wrappers[kernel] if kernel else K.fused_energy_update)(*args)
    torch.cuda.synchronize()
    launched = {k: f.launches - before[k] for k, f in wrappers.items()}
    check(launched == {k: int(k == want) for k in wrappers},
          f"n={n} L={L}: launches {launched}, want one of {want}")
    E_r, C_r = K.fused_energy_update_reference(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(E_k, E_r, **F32_TOL)
        torch.testing.assert_close(C_k, C_r, **F32_TOL)
    else:
        e_r = E_r.float()
        ulp = torch.exp2(torch.floor(torch.log2(e_r.abs().clamp_min(1e-30))) - 7)
        bad = int(((E_k.float() - e_r).abs() > ulp).sum())
        check(bad == 0, f"{bad} values of E differ by more than one bf16 ulp")
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)
    err = max(float((E_k.float() - E_r.float()).abs().max()),
              float((C_k.float() - C_r.float()).abs().max()))
    log(f"  {want} n={n} L={L} {str(dtype)[6:]}: max |kernel - plain| = {err:.3g}")
    return err


def time_fused_update(K, n: int, L: int, dtype, on_device: bool = False,
                      kernel: str | None = None, reps: int = 100, plain_reps: int = 50) -> dict:
    """The kernel that `kernel_for(L)` names (or `kernel`, launched through
    its own wrapper; median of `reps` launches) and the plain version
    (median of `plain_reps`), L2 flushed, against the least time the card
    could take: the larger of the bytes over the memory rate and the
    operations over their peak rates (q·Mu, 2L² a row, on the tensor cores
    at the bf16 rate; E, max, exp, sum and divide, 6L a row, on the f32
    pipes). Beside it two floors of the product alone: with q in the three
    bf16 terms that keep its f32 accuracy (3 × 2L² a row at the bf16 rate,
    which the bf16 kernels run on the tensor cores) and on the f32 FFMA
    pipes (2L² a row, where f32 must sum it in the plain version's
    order)."""
    kernel = kernel or K.kernel_for(L)
    fn = counters()[kernel]
    args = kernel_inputs(n, L, dtype, seed=1, on_device=on_device)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn(*args)
        K.fused_energy_update_reference(*args)
    ms = median_ms(lambda: fn(*args), reps, flush)
    plain_ms = median_ms(lambda: K.fused_energy_update_reference(*args), plain_reps, flush)
    elt = args[0].element_size()
    nbytes = (5 * n * L + L * L) * elt  # E0, S, C, Mu read once; E, C' written once
    flops = n * (2 * L * L + 6 * L)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = (n * 2 * L * L / PEAK_BF16_TC_FLOP_S + n * 6 * L / PEAK_F32_FLOP_S) * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           # q·Mu with q in three bf16 terms on the tensor cores: the floor
           # of a bf16 kernel that keeps q's f32 accuracy
           "three_term_floor_ms": n * 3 * 2 * L * L / PEAK_BF16_TC_FLOP_S * 1e3,
           # q·Mu on the f32 FFMA pipes, where f32 must sum it (the plain
           # version's order): the floor of an f32 kernel that keeps it
           "ffma_floor_ms": n * 2 * L * L / PEAK_F32_FLOP_S * 1e3,
           "reps": reps, "plain_reps": plain_reps}
    log(f"  time {kernel} n={n} L={L} {str(dtype)[6:]}: kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, bound {out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); three-term floor "
        f"{out['three_term_floor_ms'] * 1e3:.2f} us, FFMA floor "
        f"{out['ffma_floor_ms'] * 1e3:.2f} us (medians of {reps} and {plain_reps} launches)")
    return out


# ---------------------------------------------------------------------------
# the lattice apply's kernels against their plain versions
# ---------------------------------------------------------------------------


def time_lattice_apply(reps: int = 100, plain_reps: int = 10) -> dict:
    """The untiled splat and slice at fullres128's shape: the plan of K's
    left frame (1088×1920, the 5-D guide, FULL_CAPACITY slots), bf16 values
    at FULL_LABELS. Checks the slice kernel bit for bit against its plain
    version on the card and the splat within one bf16 rounding of its plain
    version (both f32 sums, in other orders, rounded to bf16), each kernel's
    launch counted once; then times each wrapper (median of `reps`
    launches; the plain versions `plain_reps`), L2 flushed before each,
    against its byte bound: every input read once and the output written
    once in its dtype (the splat: src, the sorted entries and their weights,
    the slots' row and chunk starts and the bf16 table; the slice: the bf16
    table, the int64 slots, the weights and the f32 output)."""
    from depth_estimation_torch.crf.guides import stack_guide
    from depth_estimation_torch.data.synthetic import make_stereo_pair
    from depth_estimation_torch.ops import permutohedral as P
    from depth_estimation_torch.ops.cuda import lattice as LK

    left, _, _ = make_stereo_pair(np.random.RandomState(0), FULL_H, FULL_W, num_layers=6,
                                  max_disp=FULL_MAX_DISP)
    guide = stack_guide(torch.as_tensor(left.astype(np.float32), device=DEV), 0.1, 0.1)
    plan = P.build_plan(guide.reshape(FULL_H * FULL_W, -1), max_vertices=FULL_CAPACITY)
    n, d1 = plan.bary.shape
    L, C, N = FULL_LABELS, plan.capacity, n * d1
    g = torch.Generator(device=DEV).manual_seed(7)
    src = torch.rand(n, L, generator=g, device=DEV).to(torch.bfloat16)
    scale = LK.slice_scale(plan.d)
    before = LK.launch_counts()
    entries = (plan.entry_order, plan.entry_weight, plan.slot_start, plan.chunk_start)
    table = LK.lattice_splat(src, *entries)
    vals = P._blur(plan, table, False)
    out = LK.lattice_slice(vals, plan.slot, plan.bary, scale)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in LK.launch_counts().items()}
    check(launched == {"splat": 1, "slice": 1}, f"lattice kernels launched {launched}")
    check(torch.equal(out, LK.slice_untiled_reference(plan, vals)),
          "the slice kernel differs from its plain version")
    plain_table = LK.splat_untiled_reference(plan, src).float()
    gap = (table.float() - plain_table).abs()
    bad = int((gap > 2.0 ** -7 * plain_table.abs() + 1e-6 * float(plain_table.abs().max())).sum())
    check(bad == 0, f"{bad} splat values differ from the plain version by more than a bf16 ulp")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEV)
    runs = {"splat": (lambda: LK.lattice_splat(src, *entries),
                      lambda: LK.splat_untiled_reference(plan, src),
                      n * L * 2 + N * 4 + N * 4 + 2 * (C + 1) * 4 + (C + 1) * L * 2),
            "slice": (lambda: LK.lattice_slice(vals, plan.slot, plan.bary, scale),
                      lambda: LK.slice_untiled_reference(plan, vals),
                      (C + 1) * L * 2 + N * 8 + N * 4 + n * L * 4)}
    res = {"shape": [n, L], "capacity": C, "num_valid": int(plan.num_valid), "dtype": "bf16",
           "splat_max_abs_err": float(gap.max()), "reps": reps, "plain_reps": plain_reps}
    for name, (kernel, plain, nbytes) in runs.items():
        for _ in range(3):
            kernel()
            plain()
        ms = median_ms(kernel, reps, flush)
        plain_ms = median_ms(plain, plain_reps, flush)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes": nbytes,
                     "bound_share": bound_ms / ms}
        log(f"  time lattice {name} n={n} L={L} C={C} bf16: kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB; "
            f"{100 * bound_ms / ms:.1f}% of it) (medians of {reps} and {plain_reps} launches)")
    log(f"  lattice plan: {int(plan.num_valid)} of {C} slots, longest slot "
        f"{int((plan.slot_start[1:] - plan.slot_start[:-1]).max())} entries; splat max |kernel - "
        f"plain| {res['splat_max_abs_err']:.3g}")
    return res


def time_cost_volume(reps: int = 100, plain_reps: int = 5) -> dict:
    """The stereo cost volume at K's frame (1088×1920, 128 labels) and L's
    (994×1482, 320 labels), window 9, on their synthetic pairs: one kernel
    launch a call, the same bits twice, the kernel's and the plain
    version's max |error| against the float64 evaluation, the kernel's at
    most (81·3) f32 roundings of the largest value and no larger than the
    plain version's; then the routed call (median of `reps` launches) and
    the plain version (`plain_reps`), L2 flushed before each, against the
    byte bound: both images read once and the f32 volume written once."""
    from depth_estimation_torch.data.synthetic import make_stereo_pair
    from depth_estimation_torch.ops import costvolume as CV
    from depth_estimation_torch.ops.cuda import costvolume as CVK

    window, res = 9, {}
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEV)
    for tag, (h, w, L, max_disp) in {"K": (FULL_H, FULL_W, FULL_LABELS, FULL_MAX_DISP),
                                     "L": (MID_H, MID_W, MID_LABELS, MID_LABELS - 2)}.items():
        pair = make_stereo_pair(np.random.RandomState(0), h, w, num_layers=6, max_disp=max_disp)
        left, right = (torch.as_tensor(a.astype(np.float32), device=DEV) for a in pair[:2])
        before = CVK.cost_volume_kernel.launches
        got = CV.cost_volume(left, right, L, window)
        torch.cuda.synchronize()
        launched = CVK.cost_volume_kernel.launches - before
        check(launched == 1, f"{tag}: the kernel launched {launched} times, want 1")
        check(torch.equal(got, CV.cost_volume(left, right, L, window)),
              f"{tag}: two kernel runs differ")
        exact = CV.cost_volume_reference(left.double(), right.double(), L, window)
        err = float((got.double() - exact).abs().max())
        plain_err = float((CV.cost_volume_reference(left, right, L, window).double() - exact)
                          .abs().max())
        bound = window ** 2 * 3 * 2.0 ** -23 * float(exact.abs().max())
        del exact
        check(err <= bound and err <= plain_err,
              f"{tag}: max |kernel - f64| {err:.3g}, plain {plain_err:.3g}, bound {bound:.3g}")
        del got
        torch.cuda.empty_cache()
        def kernel():
            return CV.cost_volume(left, right, L, window)

        def plain():
            return CV.cost_volume_reference(left, right, L, window)

        for _ in range(3):
            kernel()
        plain()
        ms = median_ms(kernel, reps, flush)
        plain_ms = median_ms(plain, plain_reps, flush)
        nbytes = (2 * h * w * 3 + h * w * L) * 4
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        g = CVK.costvolume_geometry(h, w, 3, L, window)
        res[tag] = {"shape": [h * w, L], "window": window, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bytes": nbytes, "bound_share": bound_ms / ms,
                    "max_abs_err": err, "plain_max_abs_err": plain_err, "err_bound": bound,
                    "launches": launched, "geometry": g, "reps": reps, "plain_reps": plain_reps}
        log(f"  time cost volume {tag} ({h}x{w}, L={L}, window {window}): kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({nbytes / 1e9:.3f} GB; {100 * bound_ms / ms:.1f}% of it); max |err| vs f64 "
            f"{err:.3g} (plain {plain_err:.3g}, bound {bound:.3g})")
        del left, right
    return res


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------


def synthetic_pair(contrast: float):
    from depth_estimation_torch.data.synthetic import make_stereo_pair

    left, right, gt = make_stereo_pair(np.random.RandomState(0), H, W)
    lo = 0.5 - contrast / 2
    return ((lo + contrast * left).astype(np.float32), (lo + contrast * right).astype(np.float32),
            gt.astype(np.float32))


def run_pipeline(tag: str, contrast: float, overrides: dict, want_sort_mode: str, f32: bool) -> dict:
    from depth_estimation_torch.models.pipeline import (CRFStereoConfig, calibrate_capacity,
                                                        crf_stereo_infer)
    from depth_estimation_torch.train.metrics import bad_pixel_ratio, epe

    left, right, gt = synthetic_pair(contrast)
    t0 = time.perf_counter()
    cfg = calibrate_capacity(left, CRFStereoConfig(num_disp=LABELS, niters=NITERS),
                             tiled=True, tile_px=TILE_PX, device=DEV)
    log(f"pipeline {tag}: calibrated in {time.perf_counter() - t0:.2f} s: max_vertices="
        f"{cfg.max_vertices} sort_mode={cfg.sort_mode} tile_px={cfg.tile_px} tile_u={cfg.tile_u}")
    check(cfg.sort_mode == want_sort_mode and cfg.tile_px == TILE_PX, cfg)
    cfg = replace(cfg, fused_update=True, **overrides)

    # the main path: launch counts read from zero just around one run
    zero_launches()
    out = crf_stereo_infer(left, right, cfg, device=DEV)
    torch.cuda.synchronize()
    launches = k1_launches()
    log(f"pipeline {tag}: fused_energy_update launches in one run = {launches}")
    check(launches == NITERS, f"{launches} launches, want {NITERS}")

    plan = out["plans"][0]
    lean = plan.slot is None
    num_valid, overflow = int(plan.num_valid), int(plan.tile_overflow)
    log(f"pipeline {tag}: plan {'lean per-tile' if lean else 'general + tiled tables'}, "
        f"num_valid={num_valid} of {cfg.max_vertices}, tile_overflow={overflow}, "
        f"incidence {tuple(plan.tile_A.shape)} {str(plan.tile_A.dtype)[6:]}")
    check(lean == (want_sort_mode == "packed1") and plan.tile_A is not None, "plan path")
    check(overflow == 0 and num_valid <= cfg.max_vertices, "capacity overflow")
    disp = out["disparity"]
    check(disp.shape == (H, W) and disp.device.type == DEV, "disparity shape or device")
    check(bool(torch.isfinite(disp).all()), "non-finite disparity")

    def compare(what: str, other: torch.Tensor, exact: bool):
        diff = (disp.float().cpu() - other.float().cpu()).abs()
        log(f"pipeline {tag}: |disparity - {what}| max {float(diff.max()):.3g} px, "
            f"mean {float(diff.mean()):.3g} px")
        if exact:
            check(float(diff.max()) <= DISP_ATOL, f"max over {DISP_ATOL} px against {what}")
        else:
            check(float(diff.mean()) <= BF16_MEAN_TOL, f"mean over {BF16_MEAN_TOL} px against {what}")

    unfused = crf_stereo_infer(left, right, replace(cfg, fused_update=False), device=DEV)["disparity"]
    compare("same pipeline without the kernel, on the card", unfused, f32)
    on_cpu = crf_stereo_infer(left, right, cfg, device="cpu")["disparity"]
    compare("the port's CPU run", on_cpu, f32)

    g = torch.as_tensor(gt, device=DEV)
    mask = (g > 0).float()
    for name, d in (("unary", out["disparity_unary"]), ("CRF", disp)):
        log(f"pipeline {tag}: {name} EPE {float(epe(d, g, mask)):.4f} px, "
            f"bad-2 {float(bad_pixel_ratio(d, g, 2.0, mask)):.4f}")

    crf_stereo_infer(left, right, cfg, device=DEV)  # warm-up
    ms = median_ms(lambda: crf_stereo_infer(left, right, cfg, device=DEV), 10)
    log(f"pipeline {tag}: warm pipeline {ms:.3f} ms (median of 10, CUDA events)")
    busy_ms = profile(f"pipeline {tag}", lambda: crf_stereo_infer(left, right, cfg, device=DEV))
    return {"launches": launches, "ms": ms, "device_busy_ms": busy_ms, "lean": lean,
            "sort_mode": cfg.sort_mode, "max_vertices": cfg.max_vertices,
            "tile_u": cfg.tile_u, "num_valid": num_valid}


def profile(tag: str, fn, top: int = 8, share_of: str | None = None):
    """One warm run under torch.profiler: device busy time against the
    run's wall time, and the kernels that take the most device time.
    Returns the busy ms, or None where the profiler saw no device time;
    with `share_of`, (busy ms, the device ms of the kernels whose name
    holds it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        log(f"{tag}: profiler saw no device time: busy share not measured")
        return None if share_of is None else (None, None)
    log(f"{tag}: profiled run {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(r[1] for r in rows)} device ops; top by device time:")
    for t, count, key in sorted(rows, reverse=True)[:top]:
        log(f"    {t:8.3f} ms {count:4d}x  {key[:90]}")
    if share_of is None:
        return busy_ms
    mine = sum(t for t, _, key in rows if share_of in key)
    log(f"{tag}: {share_of} takes {mine:.3f} of {busy_ms:.3f} device ms "
        f"({100 * mine / busy_ms:.1f}%)")
    return busy_ms, mine


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------


def trainable_inputs(left, right, gt, device: str) -> dict:
    """C's tensors on `device`: the images, the ground truth, the unary logits."""
    from depth_estimation_torch.models.pipeline import CRFStereoConfig, stereo_unary

    t = {k: torch.as_tensor(v, device=device) for k, v in (("left", left), ("right", right),
                                                            ("gt", gt))}
    t["logits"] = -stereo_unary(t["left"], t["right"], CRFStereoConfig(num_disp=LABELS))
    return t


def trainable_loss(model, t: dict, kw: dict):
    """C's loss on t's tensors: the training configuration's loss
    (`tools.bench_suite.trainable_loss`) against t's ground truth where it
    is known."""
    from depth_estimation_torch.tools.bench_suite import trainable_loss as loss

    return loss(model, t["left"], t["logits"], t["gt"], (t["gt"] > 0).float(), NITERS, kw)


def first_step(t: dict, kw: dict):
    """The loss and gradients of a fresh model's first step on t's device."""
    from depth_estimation_torch.models.refiner import CRFasRNN

    model = CRFasRNN(backend="lattice", device=t["left"].device)
    loss = trainable_loss(model, t, kw)
    loss.backward()
    return loss.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def run_trainable_step() -> dict:
    """C: calibrate, hold the first step against the CPU, time and profile."""
    from depth_estimation_torch.models.refiner import CRFasRNN
    from depth_estimation_torch.tools.bench_suite import trainable_plan

    left, right, gt = synthetic_pair(0.5)
    t = trainable_inputs(left, right, gt, DEV)
    t0 = time.perf_counter()
    kw = trainable_plan(t["left"])
    log(f"step C: calibrated in {time.perf_counter() - t0:.2f} s: {kw}")

    zero_launches()
    loss_gpu, grads_gpu = first_step(t, kw)
    torch.cuda.synchronize()
    launches = k1_launches()
    check(launches == 0, f"the training step launched {launches} fused updates")
    check(np.isfinite(loss_gpu) and all(bool(torch.isfinite(g).all()) for g in grads_gpu.values()),
          "non-finite loss or gradient")
    check(float(grads_gpu["w.s_ij"].abs()) > 0, "no gradient reaches s_ij")
    t_cpu = trainable_inputs(left, right, gt, "cpu")
    kw32 = {**kw, "tile_bf16": False}
    t0 = time.perf_counter()
    runs = {"card, bf16 blocks": (loss_gpu, grads_gpu),
            "card again, bf16 blocks": first_step(t, kw),
            "CPU, bf16 blocks": first_step(t_cpu, kw),
            "card, f32 blocks": first_step(t, kw32),
            "CPU, f32 blocks": first_step(t_cpu, kw32)}
    cpu_s = time.perf_counter() - t0
    names = sorted(grads_gpu)

    def rel(a, b):  # |a − b| against |b|, the loss and each gradient
        (la, ga), (lb, gb) = runs[a], runs[b]
        return {"loss": abs(la - lb) / abs(lb),
                **{k: float((ga[k] - gb[k]).abs().max() / gb[k].abs().max()) for k in names}}

    for name, (loss, grads) in runs.items():
        log(f"step C: first step, {name}: loss {loss:.7g}; gradients "
            + ", ".join(f"{k} {float(grads[k].flatten()[0]):.7g}" for k in names))
    diffs = {f"{a} vs {b}": rel(a, b) for a, b in (
        ("card, bf16 blocks", "CPU, bf16 blocks"), ("card again, bf16 blocks", "card, bf16 blocks"),
        ("card, f32 blocks", "CPU, f32 blocks"), ("card, bf16 blocks", "card, f32 blocks"))}
    for k, v in diffs.items():
        log(f"step C: relative difference, {k}: " + ", ".join(f"{n} {x:.3g}" for n, x in v.items()))
    d_bf16, d_f32 = diffs["card, bf16 blocks vs CPU, bf16 blocks"], diffs[
        "card, f32 blocks vs CPU, f32 blocks"]
    check(d_bf16["loss"] <= STEP_LOSS_RTOL, f"bf16 loss differs from the CPU run: {d_bf16}")
    (loss32, g32), (loss32_cpu, g32_cpu) = runs["card, f32 blocks"], runs["CPU, f32 blocks"]
    check(abs(loss32 - loss32_cpu) <= STEP_LOSS_RTOL * abs(loss32_cpu)
          and all(bool(((g32[k] - g32_cpu[k]).abs()
                        <= STEP_GRAD_ATOL + STEP_GRAD_RTOL * g32_cpu[k].abs()).all())
                  for k in names), f"the f32-block step differs from the CPU run: {d_f32}")
    bf16, f32 = runs["card, bf16 blocks"][1], g32
    check(all(torch.equal(bf16[k].sign(), f32[k].sign()) for k in ("w.s_ij", "w.s_rgb")),
          "bf16-block guide-scale gradients change sign")

    model = CRFasRNN(backend="lattice", device=DEV)
    opt = torch.optim.Adam(model.parameters(), lr=3e-2)
    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = trainable_loss(model, t, kw)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    for _ in range(2):
        step()
    ms = median_ms(step, 10)
    busy_ms = profile("step C", step)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), "non-finite loss")
    log(f"step C: step {ms:.3f} ms (median of 10 after 2 warm-up steps, CUDA events); "
        f"losses {[round(x, 6) for x in losses]}")
    return {"ms": ms, "device_busy_ms": busy_ms, "launches": launches, "first_step": {
                k: {"loss": v[0], **{n: float(v[1][n].flatten()[0]) for n in names}}
                for k, v in runs.items()}, "relative_differences": diffs,
            "four_more_first_steps_s": cpu_s, "losses": losses,
            **{k: kw[k] for k in ("max_vertices", "tile_u", "sort_mode")}}


def run_train_tsukuba() -> dict:
    """D: three steps of `train_tsukuba_crf` at the JAX defaults."""
    from depth_estimation_torch.train.experiments import train_tsukuba_crf

    left, right, gt = synthetic_pair(1.0)
    zero_launches()
    t0 = time.perf_counter()
    model, hist = train_tsukuba_crf(left, right, gt, num_steps=3, num_disp=LABELS, niters=NITERS,
                                    guidance="random", device=DEV)
    wall = time.perf_counter() - t0
    launches = k1_launches()
    check(launches == 0, f"train_tsukuba_crf launched {launches} fused updates")
    values = hist["loss"] + [hist["mse_before"], hist["mse_after"]]
    check(all(np.isfinite(values)) and all(bool(torch.isfinite(p).all())
                                           for p in model.parameters()), "non-finite values")
    step_s = statistics.median(hist["step_seconds"])
    log(f"step D: train_tsukuba_crf 3 steps in {wall:.2f} s: steps "
        f"{[round(x * 1e3, 3) for x in hist['step_seconds']]} ms (median {step_s * 1e3:.3f} ms, "
        f"host clock, each ending with its loss on the host); loss {hist['loss']}, MSE "
        f"{hist['mse_before']:.6f} before, {hist['mse_after']:.6f} after")
    return {"step_ms": step_s * 1e3, "steps_ms": [x * 1e3 for x in hist["step_seconds"]],
            "losses": hist["loss"], "mse_before": hist["mse_before"],
            "mse_after": hist["mse_after"], "launches": launches, "wall_s": wall}


# ---------------------------------------------------------------------------
# serving, the distributed code on one card, the operators
# ---------------------------------------------------------------------------


def synthetic_batch(n: int, contrast: float):
    """n pairs, pair i from `make_stereo_pair(RandomState(i), H, W)` at `contrast`."""
    from depth_estimation_torch.data.synthetic import make_stereo_pair

    lo = 0.5 - contrast / 2
    pairs = [make_stereo_pair(np.random.RandomState(i), H, W) for i in range(n)]
    return [np.stack([(lo + contrast * p[k]).astype(np.float32) for p in pairs]) for k in range(3)]


def run_serving() -> dict:
    """F: `StereoServer` on 8 pairs in A's configuration, calibrated on the
    first frame, held frame by frame against `crf_stereo_infer`."""
    from depth_estimation_torch.models.pipeline import CRFStereoConfig, crf_stereo_infer
    from depth_estimation_torch.models.serving import StereoServer

    lefts, rights, _ = synthetic_batch(SERVE_BATCH, 0.5)
    cfg = CRFStereoConfig(num_disp=LABELS, niters=NITERS, tile_bf16=True, compute_dtype="bf16",
                          fused_update=True)
    server = StereoServer(cfg, device=DEV)
    zero_launches()  # the main path: one call, calibration included
    t0 = time.perf_counter()
    out = server(lefts, rights)
    sync(DEV)
    first_s = time.perf_counter() - t0
    launches = k1_launches()
    c = server.cfg
    log(f"serving F: first call {first_s:.2f} s (calibration included): max_vertices="
        f"{c.max_vertices} sort_mode={c.sort_mode} tile_px={c.tile_px} tile_u={c.tile_u}; "
        f"fused_energy_update launches = {launches}")
    check(launches == SERVE_BATCH * NITERS, f"{launches} launches, want {SERVE_BATCH * NITERS}")
    check(out.shape == (SERVE_BATCH, H, W) and out.device.type == DEV, "served shape or device")
    check(bool(torch.isfinite(out).all()), "non-finite served disparity")
    frame_diffs = []
    for i in range(SERVE_BATCH):
        one = crf_stereo_infer(lefts[i], rights[i], c, device=DEV)["disparity"]
        d = (out[i] - one).abs()
        frame_diffs.append((float(d.max()), float(d.mean())))
    log("serving F: |served - crf_stereo_infer| per frame, max/mean px: "
        + ", ".join(f"{a:.3g}/{b:.3g}" for a, b in frame_diffs))
    check(all(m <= BF16_MEAN_TOL for _, m in frame_diffs), f"mean over {BF16_MEAN_TOL} px")
    vmapped = StereoServer(c, batch_mode="vmap", auto_capacity=False, device=DEV)(lefts, rights)
    dv = (vmapped - out).abs()
    log(f"serving F: |vmap mode - loop mode| max {float(dv.max()):.3g} px, mean "
        f"{float(dv.mean()):.3g} px, bit-equal {bool(torch.equal(vmapped, out))}")
    check(float(dv.mean()) <= BF16_MEAN_TOL, "vmap mode differs from loop mode")
    stats = server.throughput(lefts, rights, reps=5)
    log(f"serving F: throughput {stats['frames_per_s']:.2f} frames/s, {stats['ms_per_batch']:.3f} "
        f"ms a batch of {stats['batch']} (chain_timer, 5 reps), devices {stats['devices']}")
    busy_ms = profile("serving F (one batch)", lambda: server(lefts, rights))
    return {"launches": launches, "first_call_s": first_s, **stats, "device_busy_ms": busy_ms,
            "frame_max_mean_px": frame_diffs, "vmap_max_px": float(dv.max()),
            **{k: getattr(c, k) for k in ("max_vertices", "sort_mode", "tile_px", "tile_u")}}


def _stripe(x: torch.Tensor, mesh):
    t, lh = mesh.axis_index("tile"), x.shape[0] // mesh.axis_size("tile")
    return x[t * lh:(t + 1) * lh]


def sync(dev: str) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _join(settings: dict) -> None:
    """A spawned rank takes the spawning process's sizes and device (which
    a CPU rehearsal changes) and, on a GPU, the one card."""
    globals().update(settings)
    if DEV == "cuda":
        torch.cuda.set_device(0)


def _world_rank(rank: int, settings: dict, init_method: str, out_path: str) -> None:
    """One rank of G's world on cuda:0: the halo exchange of a CUDA tensor,
    the tiled stereo on the card and on the CPU, one data-parallel step."""
    from depth_estimation_torch.models.pipeline import CRFStereoConfig
    from depth_estimation_torch.models.refiner import CRFasRNN
    from depth_estimation_torch.parallel.mesh import distributed_init, make_mesh
    from depth_estimation_torch.parallel.stereo_tiled import crf_stereo_infer_tiled
    from depth_estimation_torch.parallel.tiling import gather_rows, halo_exchange_rows
    from depth_estimation_torch.train.trainer import Trainer

    _join(settings)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed_init(WORLD_BACKEND, init_method=init_method, world_size=WORLD, rank=rank)
    try:
        out = {}
        tiles = make_mesh(data=1, tile=WORLD)
        x = torch.arange(H * W * 2, dtype=torch.float32, device=DEV).reshape(H, W, 2)
        t, lh = rank, H // WORLD
        padded = halo_exchange_rows(_stripe(x, tiles), TILED_HALO, tiles)
        zeros = torch.zeros(TILED_HALO, W, 2, device=DEV)
        want = torch.cat([x[t * lh - TILED_HALO:t * lh] if t > 0 else zeros, _stripe(x, tiles),
                          x[(t + 1) * lh:(t + 1) * lh + TILED_HALO] if t < WORLD - 1 else zeros])
        check(padded.device == x.device and torch.equal(padded, want), f"rank {rank}: halo exchange")

        left, right, _ = synthetic_pair(0.5)
        left, right = torch.as_tensor(left), torch.as_tensor(right)
        cfg = CRFStereoConfig(num_disp=LABELS, niters=NITERS)
        for dev in (DEV, "cpu"):
            t0 = time.perf_counter()
            disp = crf_stereo_infer_tiled(_stripe(left, tiles), _stripe(right, tiles), cfg, tiles,
                                          halo=TILED_HALO, device=dev)
            sync(dev)
            out[f"tiled_{dev}_s"] = time.perf_counter() - t0
            out[f"tiled_{dev}"] = gather_rows(disp, tiles).cpu()

        data = make_mesh(data=WORLD)
        batch, kw = dp_batch(DEV)
        tr = Trainer(dp_loss(kw), lambda ps: torch.optim.Adam(ps, lr=3e-2), mesh=data, device=DEV)
        state = tr.init(CRFasRNN(backend="lattice", device=DEV))
        t0 = time.perf_counter()
        tr.fit(state, [batch], 1)
        sync(DEV)
        out["dp_step_s"] = time.perf_counter() - t0
        out["dp_grads"] = {k: p.grad.cpu() for k, p in state.model.named_parameters()}
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        out["params_every_rank"] = gather_rows(flat[None], data, axis="data").cpu()
        check(k1_launches() == 0, f"rank {rank} launched the fused update")
        if rank == 0:
            torch.save(out, out_path)
    finally:
        torch.distributed.destroy_process_group()


def dp_batch(device: str):
    """G's training batch: DP_PAIRS pairs (images, unary logits, ground
    truth) and C's plan options with float32 incidence blocks, calibrated
    on the first pair."""
    from depth_estimation_torch.models.pipeline import CRFStereoConfig, stereo_unary
    from depth_estimation_torch.tools.bench_suite import trainable_plan

    lefts, rights, gts = (torch.as_tensor(a, device=device) for a in synthetic_batch(DP_PAIRS, 0.5))
    logits = torch.stack([-stereo_unary(lefts[i], rights[i], CRFStereoConfig(num_disp=LABELS))
                          for i in range(DP_PAIRS)])
    kw = {**trainable_plan(lefts[0]), "tile_bf16": False}
    return {"left": lefts, "logits": logits, "gt": gts}, kw


def dp_loss(kw: dict):
    """The mean over a batch's pairs of C's loss."""
    def loss_fn(model, b):
        return sum(trainable_loss(model, {k: v[i] for k, v in b.items()}, kw)
                   for i in range(b["left"].shape[0])) / b["left"].shape[0]
    return loss_fn


def _probe_rank(rank: int, settings: dict, init_method: str, out_dir: str) -> None:
    """Whether gloo's point-to-point ops take CUDA tensors: one exchange of
    a CUDA tensor between 2 ranks, the answer written to a file."""
    from datetime import timedelta

    import torch.distributed as dist

    _join(settings)
    dist.init_process_group("gloo", init_method=init_method, world_size=2, rank=rank,
                            timeout=timedelta(seconds=30))
    try:
        mine = torch.full((4,), float(rank + 1), device=DEV)
        theirs = torch.zeros(4, device=DEV)
        try:
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, 1 - rank),
                                               dist.P2POp(dist.irecv, theirs, 1 - rank)]):
                req.wait()
            got = theirs.cpu().tolist()
            answer = "took them" if got == [float(2 - rank)] * 4 else f"took them, wrong values {got}"
        except RuntimeError as e:  # the probe reports the refusal; it does not fail
            answer = f"refused them: {str(e).splitlines()[0][:160]}"
        with open(f"{out_dir}/probe{rank}.txt", "w") as f:
            f.write(answer)
    finally:
        dist.destroy_process_group()


def run_world() -> dict:
    """G: a world of WORLD ranks on cuda:0 under gloo (the halo exchange,
    the tiled stereo on the card against the CPU, a data-parallel step
    against rank 0's full batch), after a 2-rank probe of gloo's
    point-to-point ops on CUDA tensors."""
    import tempfile

    import torch.multiprocessing as mp

    from depth_estimation_torch.models.pipeline import CRFStereoConfig, crf_stereo_infer
    from depth_estimation_torch.models.refiner import CRFasRNN

    log(f"world G: backend {WORLD_BACKEND!r}, passed explicitly: {WORLD} ranks share one card "
        "(cuda:0), and NCCL refuses two ranks on one GPU; gloo moves host memory, so the port "
        "stages CUDA tensors through host copies")
    settings = {"H": H, "W": W, "DEV": DEV}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            mp.spawn(_probe_rank, args=(settings, f"file://{tmp}/probe_rendezvous", tmp), nprocs=2)
            answers = [open(f"{tmp}/probe{r}.txt").read() for r in range(2)]
        except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:  # an answer too
            answers = [f"a rank died: {str(e).splitlines()[0][:160]}"]
        log(f"world G: probe, gloo point-to-point on CUDA tensors: {answers} "
            f"({time.perf_counter() - t0:.1f} s)")

        zero_launches()
        t0 = time.perf_counter()
        mp.spawn(_world_rank, args=(settings, f"file://{tmp}/rendezvous", f"{tmp}/out.pt"),
                 nprocs=WORLD)
        wall = time.perf_counter() - t0
        out = torch.load(f"{tmp}/out.pt", weights_only=False)
    log(f"world G: {WORLD} ranks ran in {wall:.1f} s (process start included); the halo "
        f"exchange of a CUDA tensor matched slicing on every rank")

    left, right, _ = synthetic_pair(0.5)
    card, cpu = out[f"tiled_{DEV}"], out["tiled_cpu"]
    d = (card - cpu).abs()
    untiled = crf_stereo_infer(left, right, CRFStereoConfig(num_disp=LABELS, niters=NITERS),
                               device=DEV)["disparity"].cpu()
    interior = (card - untiled).abs()[8:-8]
    log(f"world G: tiled stereo, halo {TILED_HALO}: card {out[f'tiled_{DEV}_s']:.2f} s, CPU "
        f"{out['tiled_cpu_s']:.2f} s on rank 0; |card - CPU| max {float(d.max()):.3g} px, mean "
        f"{float(d.mean()):.3g} px; interior |tiled - untiled| on the card mean "
        f"{float(interior.mean()):.4f} px, max {float(interior.max()):.3g} px (not gated)")
    check(card.shape == (H, W) and bool(torch.isfinite(card).all()), "tiled shape or values")
    check(float(d.max()) <= DISP_ATOL, f"tiled card against CPU over {DISP_ATOL} px")

    batch, kw = dp_batch(DEV)
    model = CRFasRNN(backend="lattice", device=DEV)
    dp_loss(kw)(model, batch).backward()
    full = {k: p.grad.cpu() for k, p in model.named_parameters()}
    rel = {}
    for k, g in full.items():
        got = out["dp_grads"][k]
        rel[k] = float((got - g).abs().max() / g.abs().max())
        check(bool(((got - g).abs() <= STEP_GRAD_ATOL + STEP_GRAD_RTOL * g.abs()).all()),
              f"data-parallel gradient {k} differs from the full batch: {rel}")
    rows = out["params_every_rank"]
    same = all(torch.equal(r, rows[0]) for r in rows)
    log(f"world G: data-parallel step of CRFasRNN on {DP_PAIRS} pairs ({WORLD} ranks, one pair "
        f"each, f32 blocks) {out['dp_step_s'] * 1e3:.1f} ms on rank 0; all-reduced gradients "
        f"against rank 0's full batch, relative: "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f"; parameters equal on every rank: {same}")
    check(same, "parameters differ between ranks after the step")
    check(k1_launches() == 0, "the parent launched the fused update in G")
    return {"backend": WORLD_BACKEND, "ranks": WORLD, "wall_s": wall, "probe": answers,
            "tiled_card_s": out[f"tiled_{DEV}_s"], "tiled_cpu_s": out["tiled_cpu_s"],
            "tiled_max_px": float(d.max()), "tiled_vs_untiled_interior_mean_px":
            float(interior.mean()), "dp_step_ms": out["dp_step_s"] * 1e3, "dp_grad_rel": rel}


def rayleigh(plan, degree, U):
    """Rayleigh quotients and residual norms of U's columns under the sym
    Laplacian, and the bound under which the solver counts them converged
    (eps·10·n·(θ + ‖Au‖) for A = 2I − L)."""
    from depth_estimation_torch.ops.spectral import laplacian_matvec

    LU = laplacian_matvec(plan, degree, U, "sym")
    theta = (U * LU).sum(0) / (U * U).sum(0)
    resid = torch.linalg.vector_norm(LU - U * theta, dim=0) / torch.linalg.vector_norm(U, dim=0)
    AU = 2.0 * U - LU
    bound = (torch.finfo(U.dtype).eps * 10 * U.shape[0]
             * (2.0 - theta + torch.linalg.vector_norm(AU, dim=0)))
    return theta.cpu(), resid.cpu(), bound.cpu()


def run_operators() -> dict:
    """H: spectral segmentation, the bilateral CG refinement, the LSH filter
    and the mask composite on the 288×384 pair, each against the port's
    CPU run of the same call."""
    from depth_estimation_torch.crf.guides import stack_guide
    from depth_estimation_torch.models.maskdepth import composite_mask_depth
    from depth_estimation_torch.models.pipeline import CRFStereoConfig, stereo_unary
    from depth_estimation_torch.ops.classical import cg_refine_bilateral
    from depth_estimation_torch.ops.costvolume import expected_disparity
    from depth_estimation_torch.ops.lsh import lsh_gaussian_filter
    from depth_estimation_torch.ops.permutohedral import build_plan
    from depth_estimation_torch.ops.spectral import _adjacency, spectral_embedding, spectral_segment

    left_np, right_np, gt_np = synthetic_pair(0.5)
    out, times = {}, {}
    zero_launches()

    def timed(name, dev, fn):
        t0 = time.perf_counter()
        r = fn()
        sync(dev)
        times[f"{name}_{dev}_s"] = time.perf_counter() - t0
        return r

    for dev in (DEV, "cpu"):
        left, right = torch.as_tensor(left_np, device=dev), torch.as_tensor(right_np, device=dev)
        ref = stack_guide(left, 0.15, 0.08).reshape(H * W, -1)  # spectral_segment's guide
        U = timed("embedding", dev, lambda: spectral_embedding(ref, 8))
        plan = build_plan(ref)
        degree = torch.clamp_min(_adjacency(plan, torch.ones(H * W, 1, device=dev)), 1e-3)
        out[dev] = {"rayleigh": rayleigh(plan, degree, U)}
        if dev == DEV:
            out[dev]["labels"] = timed("segment", dev, lambda: spectral_segment(left_np, device=dev))
        unary = expected_disparity(-stereo_unary(left, right, CRFStereoConfig(num_disp=LABELS)))
        out[dev]["cg"] = timed("cg_bilateral", dev, lambda: cg_refine_bilateral(unary, left)).cpu()
        E0 = stereo_unary(left, right, CRFStereoConfig(num_disp=LABELS)).reshape(H * W, LABELS)
        guide = stack_guide(left, 0.1, 0.1).reshape(H * W, -1)  # the flagship guide
        out[dev]["lsh"] = timed("lsh", dev, lambda: lsh_gaussian_filter(
            torch.softmax(-E0, dim=-1), guide)).cpu()
        gt = torch.as_tensor(gt_np, device=dev)
        masks = torch.stack([(gt == v).float() for v in torch.unique(gt)[1:]])
        out[dev]["masks"] = masks.shape[0]
        out[dev]["composite"] = timed("composite", dev,
                                      lambda: composite_mask_depth(left, right, masks)).cpu()
    check(k1_launches() == 0, "the operators launched the fused update")
    log("operators H: seconds, card / CPU: " + ", ".join(
        f"{k} {times.get(f'{k}_{DEV}_s', float('nan')):.3f} / {times.get(f'{k}_cpu_s', float('nan')):.3f}"
        for k in ("embedding", "segment", "cg_bilateral", "lsh", "composite")))

    (th, res, bound), (th_cpu, res_cpu, _) = out[DEV]["rayleigh"], out["cpu"]["rayleigh"]
    labels = out[DEV]["labels"]
    segments = int(torch.unique(labels).numel())
    log(f"operators H: spectral embedding, 8 eigenpairs at {H}x{W}: theta "
        f"{[round(x, 5) for x in th.tolist()]}; |theta card - CPU| max "
        f"{float((th - th_cpu).abs().max()):.3g}; Rayleigh residuals {[round(x, 4) for x in res.tolist()]} "
        f"(CPU {[round(x, 4) for x in res_cpu.tolist()]}) against the solver's convergence bound "
        f"{[round(x, 3) for x in bound.tolist()]}; the JAX package's small-image gates (interior < 5e-2, "
        f"last < 0.15) {'hold' if res[:-1].max() < 5e-2 and res[-1] < 0.15 else 'do not hold'}; "
        f"spectral_segment found {segments} segments")
    check(bool((res < CONVERGED_SLACK * bound).all()),
          "an eigenpair is not converged by the solver's own test")
    check(float((th - th_cpu).abs().max()) <= 1e-3, "eigenvalues differ from the CPU run")
    check(labels.shape == (H, W) and segments >= 2, "fewer than 2 segments")

    for name, rtol in (("cg", CG_RTOL), ("lsh", LSH_RTOL)):
        a, b = out[DEV][name], out["cpu"][name]
        err = float((a - b).abs().max() / b.abs().max())
        log(f"operators H: {name} card against CPU: max |difference| / max |CPU| = {err:.3g}")
        check(bool(torch.isfinite(a).all()) and err <= rtol, f"{name} differs from the CPU run")
    comp, comp_cpu = out[DEV]["composite"], out["cpu"]["composite"]
    log(f"operators H: composite_mask_depth of {out[DEV]['masks']} masks: values "
        f"{sorted(set(comp.unique().tolist()))}, true disparities "
        f"{sorted(set(np.unique(gt_np).tolist()))}; equal to the CPU run: {torch.equal(comp, comp_cpu)}")
    check(torch.equal(comp, comp_cpu), "composite differs from the CPU run")
    return {"seconds": times, "theta": th.tolist(), "theta_max_diff_cpu":
            float((th - th_cpu).abs().max()), "rayleigh_residuals": res.tolist(),
            "segments": segments}


# ---------------------------------------------------------------------------
# detection: inference at full width, training at the recorded run's width
# ---------------------------------------------------------------------------


def rel_err(card: torch.Tensor, cpu: torch.Tensor) -> float:
    card, cpu = card.detach().double().cpu(), cpu.detach().double().cpu()
    return float((card - cpu).abs().max() / cpu.abs().max().clamp_min(1e-30))


def gate(tag: str, name: str, card, cpu, errs: dict, tol: float = DET_RTOL) -> None:
    errs[name] = e = rel_err(card, cpu)
    log(f"{tag}: {name}: max |card - CPU| / max |CPU| = {e:.3g} (tolerance {tol:g})")
    check(e <= tol, f"{tag}: {name} differs from the CPU run by {e}")


def _nearest_iou_to(thr: float, box: torch.Tensor, earlier: torch.Tensor) -> float:
    from depth_estimation_torch.ops.detection import iou_matrix

    if earlier.shape[0] == 0:
        return float("inf")
    return float((iou_matrix(box[None].double(), earlier.double())[0] - thr).abs().min())


def compare_picks(tag: str, card: dict, cpu: dict, thr: float) -> dict:
    """Two ranked pick lists from the same inputs, row by row: index (or
    class), validity, score and box must agree until the first rounding
    flip, a row whose two picks are within DET_FLIP_TOL in score, or whose
    IoU against an earlier pick of its class lies within DET_FLIP_TOL of
    the NMS threshold `thr`; any other difference fails. Returns the
    agreeing prefix and the largest score and box differences in it."""
    n = card["valid"].shape[0]
    worst_s = worst_b = 0.0
    for i in range(n):
        va, vb = bool(card["valid"][i]), bool(cpu["valid"][i])
        same_pick = bool(card["key"][i] == cpu["key"][i])
        ds = abs(float(card["scores"][i]) - float(cpu["scores"][i]))
        db = float((card["boxes"][i] - cpu["boxes"][i]).abs().max())
        if va == vb and (not va or (same_pick and ds <= DET_FLIP_TOL and db <= DET_BOX_ATOL)):
            if va:
                worst_s, worst_b = max(worst_s, ds), max(worst_b, db)
            continue
        near = min(_nearest_iou_to(thr, side["boxes"][i],
                                   cpu["boxes"][:i][cpu["cls"][:i] == side["cls"][i]])
                   for side in (card, cpu))
        log(f"{tag}: first difference at row {i} of {n}: score gap {ds:.3g}, nearest IoU to the "
            f"threshold {thr} off by {near:.3g} (flip tolerance {DET_FLIP_TOL:g})")
        check(ds <= DET_FLIP_TOL or near <= DET_FLIP_TOL,
              f"{tag}: row {i} differs by more than a rounding flip")
        return {"agree": i, "of": n, "max_score_diff": worst_s, "max_box_diff_px": worst_b}
    return {"agree": n, "of": n, "max_score_diff": worst_s, "max_box_diff_px": worst_b}


def proposal_picks(model, rpn: dict, h: int, w: int) -> dict:
    """The RPN's choice of anchors, recomputed from its outputs."""
    from depth_estimation_torch.ops.detection import clip_boxes, decode_boxes

    boxes = clip_boxes(decode_boxes(rpn["anchors"], rpn["rpn_deltas"]), h, w)
    idx, valid = model.select_proposals(boxes, rpn["rpn_scores"])
    idx, valid = idx.cpu(), valid.cpu()
    return {"key": idx, "valid": valid, "scores": rpn["rpn_scores"].cpu()[idx],
            "boxes": boxes.cpu()[idx], "cls": torch.zeros_like(idx)}


def host_syncs(fn) -> list[str]:
    """The warnings of `torch.cuda.set_sync_debug_mode('warn')` during one
    run of `fn`: every operation that made the host wait for the card."""
    import warnings

    if DEV != "cuda":
        fn()
        return []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature ...") is no sync
    return [str(w.message) for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def run_detection() -> dict:
    """I: `MaskRCNN()` on one 800×1024 image: first and warm calls, a
    profile, every stage against the port's CPU run on the card's input to
    that stage, and one `detect_augmented` with hflip."""
    from depth_estimation_torch.data.shapes import ShapesDetection
    from depth_estimation_torch.models.detection.rcnn import MaskRCNN
    from depth_estimation_torch.models.detection.tta import detect_augmented

    tag = f"detection I ({DET_H}x{DET_W})"
    img = ShapesDetection(num_items=1, h=DET_H, w=DET_W, max_shapes=3, seed=0)[0]["image"]
    image = torch.as_tensor(img.astype(np.float32), device=DEV)
    t0 = time.perf_counter()
    model = MaskRCNN(generator=torch.Generator().manual_seed(0), device=DEV).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag}: MaskRCNN() built with {n_params} parameters in {time.perf_counter() - t0:.2f} s")
    zero_launches()  # the main path: one call
    with torch.no_grad():
        t0 = time.perf_counter()
        out = model(image)
        sync(DEV)
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = k1_launches()
        model(image)
        syncs = host_syncs(lambda: model(image))
        ms = median_ms(lambda: model(image), 10)
        busy_ms = profile(tag, lambda: model(image), top=12)
    log(f"{tag}: host syncs in one warm call: "
        + (f"{len(syncs)}, the first: {syncs[0][:160]}" if syncs else "0"))
    log(f"{tag}: first call {first_ms:.3f} ms, warm {ms:.3f} ms (median of 10, CUDA events); "
        f"{int(out['valid'].sum())} valid detections, {int(out['proposal_valid'].sum())} valid "
        f"proposals; fused_energy_update launches = {launches}")
    check(launches == 0, "detection launched the fused update")
    D, P, K = model.num_detections, model.num_proposals, model.num_classes
    check(out["boxes"].shape == (D, 4) and out["masks"].shape == (D, 28, 28)
          and out["proposals"].shape == (P, 4) and out["mask_logits"].shape == (D, 28, 28, K),
          "detection output shapes")
    check(all(bool(torch.isfinite(out[k]).all()) for k in ("boxes", "scores", "masks",
                                                            "proposals", "cls_scores")),
          "non-finite detection outputs")

    cpu_model = MaskRCNN(device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    errs = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        feats = model.features(image)
        feats_cpu = cpu_model.features(image.cpu())
        for lvl, (a, b) in enumerate(zip(feats, feats_cpu)):
            gate(tag, f"P{lvl + 2} {tuple(a.shape[-2:])}", a, b, errs)
        feats_in = [f.cpu() for f in feats]
        rpn = model.rpn(feats, DET_H, DET_W)
        rpn_cpu = cpu_model.rpn(feats_in, DET_H, DET_W)
        for k in ("rpn_logits", "rpn_deltas"):
            gate(tag, k, rpn[k], rpn_cpu[k], errs)
        props = compare_picks(f"{tag}: proposals", proposal_picks(model, rpn, DET_H, DET_W),
                              proposal_picks(cpu_model, rpn_cpu, DET_H, DET_W),
                              model.rpn_nms_thresh)
        roi = model.roi_heads(feats, rpn["proposals"], rpn["proposal_valid"], DET_H, DET_W)
        roi_cpu = cpu_model.roi_heads(feats_in, rpn["proposals"].cpu(),
                                      rpn["proposal_valid"].cpu(), DET_H, DET_W)
        for k in ("cls_scores", "cls_deltas"):
            gate(tag, k, roi[k], roi_cpu[k], errs)
        dets = compare_picks(
            f"{tag}: detections",
            *({"key": r["classes"].cpu(), "cls": r["classes"].cpu(), "valid": r["valid"].cpu(),
               "scores": r["scores"].cpu(), "boxes": r["boxes"].cpu()} for r in (roi, roi_cpu)),
            model.det_nms_thresh)
        n = dets["agree"]
        check(n > 0, "no detection agrees with the CPU run")
        gate(tag, f"mask_logits of the {n} agreeing detections", roi["mask_logits"][:n],
             roi_cpu["mask_logits"][:n], errs)
        stages_s = time.perf_counter() - t0
    log(f"{tag}: proposals agree with the CPU's on {props['agree']} of {props['of']} (score "
        f"{props['max_score_diff']:.3g}, box {props['max_box_diff_px']:.3g} px), detections on "
        f"{n} of {dets['of']} (score {dets['max_score_diff']:.3g}, box "
        f"{dets['max_box_diff_px']:.3g} px); stage checks {stages_s:.1f} s")

    with torch.no_grad():
        t0 = time.perf_counter()
        aug = detect_augmented(model, image, hflip=True)
        sync(DEV)
        tta_ms = (time.perf_counter() - t0) * 1e3
    check(aug["boxes"].shape == (D, 4) and aug["scores"].shape == (D,)
          and bool(torch.isfinite(aug["boxes"]).all()) and bool(torch.isfinite(aug["scores"]).all()),
          "detect_augmented shapes or values")
    log(f"{tag}: detect_augmented (identity + hflip) {tta_ms:.3f} ms host clock, "
        f"{int(aug['valid'].sum())} valid merged detections")
    return {"first_ms": first_ms, "ms": ms, "device_busy_ms": busy_ms, "launches_k1": launches,
            "host_syncs": len(syncs),
            "parameters": n_params, "errors": errs, "proposals": props, "detections": dets,
            "tta_ms": tta_ms, "valid": int(out["valid"].sum())}


def run_detection_training() -> dict:
    """J: the first step's loss (float32 and float64) on the card against
    the CPU given the card's proposals, the card's gradients (float64 and
    float32) against the CPU's float64 ones, 2 warm-up and 10 timed Adam
    steps, the held-out mAP, and 3 steps of `train_detection_shapes`."""
    from depth_estimation_torch.data.shapes import ShapesDetection
    from depth_estimation_torch.models.detection.rcnn import MaskRCNN
    from depth_estimation_torch.train.experiments import (detection_item_tensors,
                                                          detection_loss_parts,
                                                          evaluate_detection,
                                                          train_detection_shapes)

    tag = f"training J ({J_SIZE}x{J_SIZE})"
    ds = ShapesDetection(num_items=J_ITEMS, h=J_SIZE, w=J_SIZE, max_shapes=2, seed=0)
    items = [ds.padded(i) for i in range(J_ITEMS)]
    held = ShapesDetection(num_items=J_HOLDOUT, h=J_SIZE, w=J_SIZE, max_shapes=2, seed=1000)
    held_items = [held.padded(i) for i in range(J_HOLDOUT)]
    zero_launches()
    picks = {}

    def first_step(dev: str, dtype) -> tuple:
        """A fresh model's first-step loss and gradients on `dev` in `dtype`,
        the proposals chosen by the first run (the card in float32)."""
        model = MaskRCNN(**J_MODEL, generator=torch.Generator().manual_seed(0), device=dev)
        model.to(dtype)
        if picks:
            model.select_proposals = lambda boxes, scores: tuple(x.to(dev) for x in picks["card"])
        else:
            def recording(boxes, scores):
                picks["card"] = MaskRCNN.select_proposals(model, boxes, scores)
                return picks["card"]

            model.select_proposals = recording
        loss = sum(detection_loss_parts(model, detection_item_tensors(items[0], dev, True, False))
                   .values())
        loss.backward()
        grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        check(len(grads) == len(list(model.parameters())), "a parameter has no gradient")
        check(np.isfinite(loss.item()) and all(bool(torch.isfinite(g).all())
                                               for g in grads.values()), "non-finite first step")
        return loss.item(), grads

    f32, f64 = torch.float32, torch.float64
    runs = {(dev, dt): first_step(dev, dt)
            for dev, dt in ((DEV, f32), ("cpu", f32), (DEV, f64), ("cpu", f64))}

    def worst(a, b):  # the largest max |Δ| / max |b| over the parameters
        ga, gb = runs[a][1], runs[b][1]
        rel = {k: float((ga[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
               for k, g in gb.items()}
        k = max(rel, key=rel.get)
        return rel[k], k

    loss_rel = {dt: abs(runs[(DEV, dt)][0] - runs[("cpu", dt)][0]) / abs(runs[("cpu", dt)][0])
                for dt in (f32, f64)}
    diffs = {name: worst(a, b) for name, a, b in (
        ("card f32 vs CPU f32", (DEV, f32), ("cpu", f32)),
        ("CPU f32 vs CPU f64", ("cpu", f32), ("cpu", f64)),
        ("card f32 vs CPU f64", (DEV, f32), ("cpu", f64)),
        ("card f64 vs CPU f64", (DEV, f64), ("cpu", f64)))}
    log(f"{tag}: first step given the card's proposals, loss card/CPU: float32 "
        f"{runs[(DEV, f32)][0]:.7g}/{runs[('cpu', f32)][0]:.7g} (relative {loss_rel[f32]:.3g}), "
        f"float64 {runs[(DEV, f64)][0]:.10g}/{runs[('cpu', f64)][0]:.10g} (relative "
        f"{loss_rel[f64]:.3g}); tolerance {STEP_LOSS_RTOL:g}")
    for name, (r, k) in diffs.items():
        log(f"{tag}: gradients, {name}: largest relative difference {r:.3g} ({k})")
    check(max(loss_rel.values()) <= STEP_LOSS_RTOL, "first-step loss differs from the CPU run")
    g64_cpu = runs[("cpu", f64)][1]
    for dt in (f64, f32):
        g = runs[(DEV, dt)][1]
        check(all(bool(((g[k] - ref).abs() <= STEP_GRAD_ATOL + STEP_GRAD_RTOL * ref.abs()).all())
                  for k, ref in g64_cpu.items()),
              f"the card's {str(dt)[6:]} first-step gradients differ from the CPU's float64 ones")

    model = MaskRCNN(**J_MODEL, generator=torch.Generator().manual_seed(0), device=DEV)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tensors = [detection_item_tensors(it, DEV, True, False) for it in items]
    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = sum(detection_loss_parts(model, tensors[len(losses) % J_ITEMS]).values())
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    for _ in range(2):
        step()
    ms = median_ms(step, 10)
    busy_ms = profile(tag, step, top=12)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), "non-finite training loss")
    t0 = time.perf_counter()
    ev = evaluate_detection(model, held_items)
    eval_s = time.perf_counter() - t0
    log(f"{tag}: step {ms:.3f} ms (median of 10 after 2 warm-up steps, CUDA events); losses "
        f"{[round(x, 4) for x in losses]}; held-out ({J_HOLDOUT} items) mAP@0.5 {ev['map50']:.4f}, "
        f"mAP {ev['map']:.4f}, COCO mAP@0.5 {ev['coco_map50']:.4f} in {eval_s:.2f} s (random "
        "init and 13 steps: not gated)")
    t0 = time.perf_counter()
    _, hist = train_detection_shapes(num_steps=3, num_items=J_ITEMS, h=J_SIZE, holdout=J_HOLDOUT,
                                     model_kwargs={k: J_MODEL[k] for k in ("blocks", "fpn_dim")},
                                     device=DEV)
    entry_s = time.perf_counter() - t0
    check(all(np.isfinite(hist["loss"])), "train_detection_shapes: non-finite loss")
    log(f"{tag}: train_detection_shapes, 3 steps and the held-out mAP in {entry_s:.2f} s: steps "
        f"{[round(x * 1e3, 3) for x in hist['step_seconds']]} ms (host clock), mAP@0.5 "
        f"{hist['map50']:.4f}, mask IoU {hist['mask_iou']:.4f}")
    launches = k1_launches()
    check(launches == 0, "detection training launched the fused update")
    return {"first_step": {"loss": {f"{d}_{str(t)[6:]}": v[0] for (d, t), v in runs.items()},
                           "loss_rel": {str(t)[6:]: v for t, v in loss_rel.items()},
                           "grad_rel": {k: v[0] for k, v in diffs.items()}}, "ms": ms, "device_busy_ms": busy_ms,
            "losses": losses, "heldout": ev, "eval_s": eval_s, "entry_steps_ms":
            [x * 1e3 for x in hist["step_seconds"]], "entry_map50": hist["map50"],
            "launches_k1": launches}


# ---------------------------------------------------------------------------
# fullres128: the fused update at 128 labels (K1w); the native CPU lattice
# ---------------------------------------------------------------------------


def check_native() -> float:
    """The C++ CPU lattice (built beside the kernels) against the port's
    `lattice_filter` on the CPU, to tests/test_native.py's 2e-4."""
    from depth_estimation_torch.ops.permutohedral import lattice_filter
    from depth_estimation_torch.utils.native import lattice_filter_cpu

    rs = np.random.RandomState(5)
    ref = (rs.randn(4096, 5) * 1.5).astype(np.float32)
    src = rs.rand(4096, 16).astype(np.float32)
    want = lattice_filter(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    err = float(np.abs(lattice_filter_cpu(src, ref) - want).max())
    log(f"native CPU lattice (4096 points, d=5, 16 values): max |native - lattice_filter| "
        f"= {err:.3g}")
    check(err <= 2e-4 * (1 + float(np.abs(want).max())), "native CPU lattice disagrees")
    return err


def plain_split_k(E0, S, C, Mu):
    """The plain version with Q'·Mu summed over the two halves of l apart
    (another order of the same f32 sums)."""
    E = E0.float() + (S.float() - C.float())
    Q, h = torch.softmax(-E, dim=-1), Mu.shape[0] // 2
    Cn = Q[:, :h] @ Mu[:h].float() + Q[:, h:] @ Mu[h:].float()
    return E.to(E0.dtype), Cn.to(E0.dtype)


def plain_f64(E0, S, C, Mu):
    """The plain version with the softmax and Q'·Mu in float64 and C'
    rounded once (closer to the exact function than any f32 order)."""
    E = E0.float() + (S.float() - C.float())
    Cn = torch.softmax(-E.double(), dim=-1) @ Mu.double()
    return E.to(E0.dtype), Cn.to(E0.dtype)


def run_fullres() -> dict:
    """K: fullres128 with bf16 state and the fused update: 5 launches of K1w
    and none of K1, a finite disparity, within BF16_MEAN_TOL of the same run
    without the kernel (its plain version in its place), the fused loop
    within DISP_ATOL of the unfused one in float32, and the 192×256 crop in
    float32 against the CPU."""
    from depth_estimation_torch.data.synthetic import make_stereo_pair
    from depth_estimation_torch.models import pipeline as P
    from depth_estimation_torch.models.pipeline import crf_stereo_infer
    from depth_estimation_torch.ops.cuda.meanfield import (fused_energy_update,
                                                           fused_energy_update_reference)
    from depth_estimation_torch.tools.bench_suite import lattice_cfg
    from depth_estimation_torch.train.metrics import bad_pixel_ratio, epe
    from depth_estimation_torch.utils.timing import jitter, loop_timer, scalarize

    tag = f"K (fullres128, {FULL_H}x{FULL_W}, L={FULL_LABELS}, bf16, fused)"
    left, right, gt = make_stereo_pair(np.random.RandomState(0), FULL_H, FULL_W, num_layers=6,
                                       max_disp=FULL_MAX_DISP)
    left, right, gt = left.astype(np.float32), right.astype(np.float32), gt.astype(np.float32)
    t0 = time.perf_counter()
    cfg = lattice_cfg(FULL_LABELS, left, DEV)
    calib_s = time.perf_counter() - t0
    tiled = cfg.tile_px is not None
    log(f"{tag}: calibrated in {calib_s:.2f} s: tiled={tiled} tile_px={cfg.tile_px} "
        f"tile_u={cfg.tile_u} max_vertices={cfg.max_vertices} sort_mode={cfg.sort_mode} "
        f"tile_bf16={cfg.tile_bf16}")

    # the main path: launch counts read from zero just around one run
    from depth_estimation_torch.ops.cuda import costvolume as CVK
    from depth_estimation_torch.ops.cuda import lattice as LK

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    LK.zero_launch_counts()
    CVK.cost_volume_kernel.launches = 0
    t0 = time.perf_counter()
    out = crf_stereo_infer(left, right, cfg, device=DEV)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = launches()
    k1, k1w = got["K1"], got["K1w"]
    lattice = LK.launch_counts()
    costvolume = CVK.cost_volume_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: first run {first_s:.2f} s; launches in one run: {got}, lattice {lattice}, "
        f"cost volume {costvolume}; peak device memory {peak / 2**30:.2f} GiB")
    only_launched("K1w", NITERS)
    check(costvolume == 1, f"cost volume kernel launched {costvolume} times, want 1")
    # an untiled plan: each apply's splat and slice run the lattice kernels
    check(cfg.tile_px is not None or lattice == {"splat": NITERS, "slice": NITERS},
          f"lattice kernels launched {lattice}, want {NITERS} of each")
    plan = out["plans"][0]
    num_valid = int(plan.num_valid)
    overflow = 0 if plan.tile_overflow is None else int(plan.tile_overflow)  # tiled plans only
    log(f"{tag}: plan {'lean per-tile' if plan.slot is None else 'general'}"
        f"{' + tiled tables' if plan.tile_A is not None else ''}, num_valid={num_valid} of "
        f"{cfg.max_vertices}, tile_overflow={overflow}"
        + (f", incidence {tuple(plan.tile_A.shape)} {str(plan.tile_A.dtype)[6:]}"
           if plan.tile_A is not None else ""))
    check(overflow == 0 and num_valid <= cfg.max_vertices, "capacity overflow")
    disp = out["disparity"]
    check(disp.shape == (FULL_H, FULL_W) and disp.device.type == DEV, "disparity shape or device")
    check(bool(torch.isfinite(disp).all()), "non-finite disparity")
    g = torch.as_tensor(gt, device=DEV)
    mask = (g > 0).float()
    for name, d in (("unary", out["disparity_unary"]), ("CRF", disp)):
        log(f"{tag}: {name} EPE {float(epe(d, g, mask)):.4f} px, "
            f"bad-2 {float(bad_pixel_ratio(d, g, 2.0, mask)):.4f}")
    disp = disp.cpu()
    del out, plan

    # Without the kernel, on the card. At 128 labels the bf16 state is
    # noise-bound: two runs of this very pipeline differ by ~0.07 px mean
    # (index_add_'s atomics sum in no fixed order and bf16 rounds the
    # difference up), and the unfused loop, which rounds at other points,
    # by ~0.3 px with the plain version in K1w's place as with K1w. So the
    # kernel is held against the same fused run with its plain version in
    # its place, both under deterministic algorithms (bf16, within
    # BF16_MEAN_TOL), and the fused loop against the unfused one in float32
    # (DISP_ATOL, B's gate); the bf16 unfused run is printed.
    def run(c, plain=False, update=None):
        if plain or update is not None:
            P.fused_energy_update = update or fused_energy_update_reference
        try:
            return crf_stereo_infer(left, right, c, device=DEV)["disparity"].float().cpu()
        finally:
            P.fused_energy_update = fused_energy_update

    def compare(what, a, b, tol, mean=False):
        d = (a - b).abs()
        differ = int((d > 0).sum())
        log(f"{tag}: |{what}| max {float(d.max()):.3g} px, mean {float(d.mean()):.3g} px, "
            f"{differ} of {d.numel()} pixels differ"
            + ("" if tol is None else f" (gate: {'mean' if mean else 'max'} <= {tol})"))
        if tol is not None:
            check(float(d.mean() if mean else d.max()) <= tol, f"{what} over {tol} px")
        return float(d.mean()), float(d.max()), differ

    diffs = {"repeat_bf16": compare("disparity - a repeat of the same run (printed)", disp,
                                    run(cfg), None),
             "unfused_bf16": compare("disparity - the unfused bf16 loop (printed)", disp,
                                     run(replace(cfg, fused_update=False)), None)}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cf = replace(cfg, compute_dtype="f32")
        diffs["plain_bf16"] = compare("K1w's run - the plain version's in its place, bf16, "
                                      "deterministic", run(cfg), run(cfg, plain=True),
                                      BF16_MEAN_TOL, mean=True)
        unfused_f32 = run(replace(cf, fused_update=False))
        diffs["unfused_f32"] = compare("fused f32 run - the unfused f32 loop, deterministic",
                                       run(cf), unfused_f32, DISP_ATOL)
        # what that gate tolerates: the plain version with another rounding
        # of Q'·Mu in K1w's place (printed): why K1w's f32 path repeats the
        # plain version's arithmetic instead of a tensor-core product
        for key, fn in (("split_k_f32", plain_split_k), ("f64_rounded_f32", plain_f64)):
            diffs[key] = compare(f"fused f32 run with the plain version's {key} variant in K1w's "
                                 "place - the unfused f32 loop, deterministic (printed)",
                                 run(cf, update=fn), unfused_f32, None)
    finally:
        torch.use_deterministic_algorithms(False)

    # the crop, in float32 (state and incidence blocks), against the CPU
    lc, rc = left[:CROP_H, :CROP_W], right[:CROP_H, :CROP_W]
    ccfg = replace(lattice_cfg(FULL_LABELS, lc, DEV), tile_bf16=False, compute_dtype="f32")
    zero_launches()
    CVK.cost_volume_kernel.launches = 0
    crop_card = crf_stereo_infer(lc, rc, ccfg, device=DEV)["disparity"]
    torch.cuda.synchronize()
    crop_k1w = only_launched("K1w", NITERS)
    crop_costvolume = CVK.cost_volume_kernel.launches
    check(crop_costvolume == 1, f"crop: cost volume kernel launched {crop_costvolume} times")
    t0 = time.perf_counter()
    crop_cpu = crf_stereo_infer(lc, rc, ccfg, device="cpu")["disparity"]
    crop_cpu_s = time.perf_counter() - t0
    crop_diff = float((crop_card.cpu() - crop_cpu).abs().max())
    log(f"{tag}: {CROP_H}x{CROP_W} crop in f32 (tile_px={ccfg.tile_px} tile_u={ccfg.tile_u}, "
        f"K1w launches {crop_k1w}): |card - the port's CPU run| max {crop_diff:.3g} px "
        f"(CPU run {crop_cpu_s:.1f} s)")
    check(crop_diff <= DISP_ATOL, f"crop: max over {DISP_ATOL} px against the CPU")

    crf_stereo_infer(left, right, cfg, device=DEV)  # warm-up
    ms = median_ms(lambda: crf_stereo_infer(left, right, cfg, device=DEV), 3)
    # the same pipeline timed as tools/bench_suite.py times it (a chain of
    # calls, differenced), which leaves out the host's start of each call
    # that a single call's events hold: O's yardstick
    lt, rt = (torch.as_tensor(x, device=DEV) for x in (left, right))
    chain_ms = 1e3 * loop_timer(lambda a: a + scalarize(crf_stereo_infer(
        jitter(lt, a), rt, cfg, device=DEV)["disparity"]), reps=3, device=DEV)
    log(f"{tag}: warm pipeline {ms:.3f} ms (median of 3, CUDA events), {chain_ms:.3f} ms a call "
        "in a chain of 3 (the suite's timer)")
    busy_ms, k1w_ms = profile(f"pipeline {tag}",
                              lambda: crf_stereo_infer(left, right, cfg, device=DEV),
                              share_of="fused_energy_update_wide_kernel")
    return {"launches_k1w": k1w, "launches_k1": k1,
            "launches_lattice": lattice, "ms": ms, "chain_ms": chain_ms, "device_busy_ms": busy_ms,
            "k1w_device_ms": k1w_ms, "k1w_share": k1w_ms / busy_ms if busy_ms else None,
            "first_s": first_s, "calibrate_s": calib_s, "tiled": tiled, "tile_u": cfg.tile_u,
            "max_vertices": cfg.max_vertices, "sort_mode": cfg.sort_mode, "num_valid": num_valid,
            "peak_bytes": peak, "mean_max_abs_diff": diffs, "crop_max_abs_diff_cpu": crop_diff,
            "crop_launches_k1w": crop_k1w, "launches_costvolume": costvolume,
            "crop_launches_costvolume": crop_costvolume}


def run_wide_disparity() -> dict:
    """L: a half-size Middlebury frame at 320 labels with bf16 state and the
    fused update: 5 launches of K1x and none of the other kernels, a finite
    disparity, within BF16_MEAN_TOL of the same run with K1x's plain version
    in its place, the fused loop within DISP_ATOL of the unfused one in
    float32, the 96x384 crop in float32 against the CPU; the warm pipeline,
    one profile, peak memory."""
    from depth_estimation_torch.data.synthetic import make_stereo_pair
    from depth_estimation_torch.models import pipeline as P
    from depth_estimation_torch.models.pipeline import crf_stereo_infer
    from depth_estimation_torch.ops.cuda.meanfield import (fused_energy_update,
                                                           fused_energy_update_reference)
    from depth_estimation_torch.tools.bench_suite import lattice_cfg

    tag = f"L (wide disparity, {MID_H}x{MID_W}, L={MID_LABELS}, bf16, fused)"
    left, right, gt = make_stereo_pair(np.random.RandomState(0), MID_H, MID_W, num_layers=6,
                                       max_disp=MID_LABELS - 2)
    left, right = left.astype(np.float32), right.astype(np.float32)
    t0 = time.perf_counter()
    cfg = lattice_cfg(MID_LABELS, left, DEV)
    calib_s = time.perf_counter() - t0
    tiled = cfg.tile_px is not None
    log(f"{tag}: calibrated in {calib_s:.2f} s: tiled={tiled} tile_px={cfg.tile_px} "
        f"tile_u={cfg.tile_u} max_vertices={cfg.max_vertices} sort_mode={cfg.sort_mode} "
        f"tile_bf16={cfg.tile_bf16}")

    # the main path: launch counts read from zero just around one run
    from depth_estimation_torch.ops.cuda import costvolume as CVK

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    CVK.cost_volume_kernel.launches = 0
    t0 = time.perf_counter()
    out = crf_stereo_infer(left, right, cfg, device=DEV)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = launches()
    costvolume = CVK.cost_volume_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: first run {first_s:.2f} s; launches in one run: {got}, cost volume "
        f"{costvolume}; peak device memory {peak / 2**30:.2f} GiB")
    k1x = only_launched("K1x", NITERS)
    check(costvolume == 1, f"cost volume kernel launched {costvolume} times, want 1")
    plan = out["plans"][0]
    overflow = 0 if plan.tile_overflow is None else int(plan.tile_overflow)
    check(overflow == 0 and int(plan.num_valid) <= cfg.max_vertices, "capacity overflow")
    disp = out["disparity"]
    check(disp.shape == (MID_H, MID_W) and disp.device.type == DEV, "disparity shape or device")
    check(bool(torch.isfinite(disp).all()), "non-finite disparity")
    del out, plan, disp

    def run(c, update=None):
        if update is not None:
            P.fused_energy_update = update
        try:
            return crf_stereo_infer(left, right, c, device=DEV)["disparity"].float().cpu()
        finally:
            P.fused_energy_update = fused_energy_update

    def compare(what, a, b, tol, mean=False):
        d = (a - b).abs()
        log(f"{tag}: |{what}| max {float(d.max()):.3g} px, mean {float(d.mean()):.3g} px, "
            f"{int((d > 0).sum())} of {d.numel()} pixels differ (gate: "
            f"{'mean' if mean else 'max'} <= {tol})")
        check(float(d.mean() if mean else d.max()) <= tol, f"{what} over {tol} px")
        return float(d.mean()), float(d.max())

    # as in K: the bf16 state is held against the same run with the plain
    # version in K1x's place, the fused f32 loop against the unfused one
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        diffs = {"plain_bf16": compare("K1x's run - the plain version's in its place, bf16, "
                                       "deterministic", run(cfg),
                                       run(cfg, fused_energy_update_reference), BF16_MEAN_TOL,
                                       mean=True)}
        cf = replace(cfg, compute_dtype="f32")
        diffs["unfused_f32"] = compare("fused f32 run - the unfused f32 loop, deterministic",
                                       run(cf), run(replace(cf, fused_update=False)), DISP_ATOL)
    finally:
        torch.use_deterministic_algorithms(False)

    # the crop, wider than L, in float32 (state and incidence blocks), against the CPU
    lc, rc = left[:MID_CROP_H, :MID_CROP_W], right[:MID_CROP_H, :MID_CROP_W]
    ccfg = replace(lattice_cfg(MID_LABELS, lc, DEV), tile_bf16=False, compute_dtype="f32")
    zero_launches()
    CVK.cost_volume_kernel.launches = 0
    crop_card = crf_stereo_infer(lc, rc, ccfg, device=DEV)["disparity"]
    torch.cuda.synchronize()
    crop_k1x = only_launched("K1x", NITERS)
    crop_costvolume = CVK.cost_volume_kernel.launches
    check(crop_costvolume == 1, f"crop: cost volume kernel launched {crop_costvolume} times")
    t0 = time.perf_counter()
    crop_cpu = crf_stereo_infer(lc, rc, ccfg, device="cpu")["disparity"]
    crop_cpu_s = time.perf_counter() - t0
    crop_diff = float((crop_card.cpu() - crop_cpu).abs().max())
    log(f"{tag}: {MID_CROP_H}x{MID_CROP_W} crop in f32 (tile_px={ccfg.tile_px} tile_u="
        f"{ccfg.tile_u}, K1x launches {crop_k1x}): |card - the port's CPU run| max "
        f"{crop_diff:.3g} px (CPU run {crop_cpu_s:.1f} s)")
    check(crop_diff <= DISP_ATOL, f"crop: max over {DISP_ATOL} px against the CPU")

    crf_stereo_infer(left, right, cfg, device=DEV)  # warm-up
    ms = median_ms(lambda: crf_stereo_infer(left, right, cfg, device=DEV), 3)
    log(f"{tag}: warm pipeline {ms:.3f} ms with K1x (median of 3, CUDA events)")
    busy_ms, k1x_ms = profile(f"pipeline {tag}",
                              lambda: crf_stereo_infer(left, right, cfg, device=DEV),
                              share_of="fused_energy_update_xwide")
    return {"launches_k1x": k1x, "launches": got, "ms": ms,
            "device_busy_ms": busy_ms, "k1x_device_ms": k1x_ms,
            "k1x_share": k1x_ms / busy_ms if busy_ms else None, "first_s": first_s,
            "calibrate_s": calib_s, "tiled": tiled, "tile_px": cfg.tile_px, "tile_u": cfg.tile_u,
            "max_vertices": cfg.max_vertices, "sort_mode": cfg.sort_mode, "peak_bytes": peak,
            "mean_max_abs_diff": diffs, "crop_max_abs_diff_cpu": crop_diff,
            "crop_launches_k1x": crop_k1x, "launches_costvolume": costvolume,
            "crop_launches_costvolume": crop_costvolume}


def counting_flips(update, tally: dict, key: str):
    """`update` (a fused update), also counting into tally[key] the share
    of C' values it rounds otherwise than the plain version on the same
    inputs (over every call)."""
    from depth_estimation_torch.ops.cuda.meanfield import fused_energy_update_reference

    seen = [0, 0]

    def counted(E0, S, C, Mu):
        E, Cn = update(E0, S, C, Mu)
        seen[0] += int((Cn != fused_energy_update_reference(E0, S, C, Mu)[1]).sum())
        seen[1] += Cn.numel()
        tally[key] = seen[0] / seen[1]
        return E, Cn
    return counted


def one_ulp_flips(share: float, seed: int):
    """The plain version with a random `share` of its nonzero bf16 C'
    values moved by one ulp, up or down at random (a seeded generator on
    the card): rounding noise of that share, with no bias."""
    from depth_estimation_torch.ops.cuda.meanfield import fused_energy_update_reference

    g = torch.Generator(device=DEV).manual_seed(seed)

    def flipped(E0, S, C, Mu):
        E, Cn = fused_energy_update_reference(E0, S, C, Mu)
        pick = (torch.rand(Cn.shape, generator=g, device=Cn.device) < share) & (Cn != 0)
        step = torch.where(torch.rand(Cn.shape, generator=g, device=Cn.device) < 0.5, 1, -1)
        bits = Cn.view(torch.int16) + (pick * step).to(torch.int16)  # one ulp of |C'|
        return E, bits.view(torch.bfloat16)
    return flipped


def rounding_witness(tag: str, run, compare, cfg, fused_bf16, plain_bf16, flips: dict) -> dict:
    """What rounding alone does to M's bf16 gate (printed, not gated): the
    plain version with the share of C' values K1xx rounds otherwise (in
    `flips`) moved by one ulp at random, two seeds, against the plain
    version; and the plain version with Q'·Mu in float64, rounded once
    (`plain_f64`), against the plain version and against K1xx. If K1xx's
    gap to the plain version is rounding, it is of the size of these."""
    share = flips["K1xx"]
    f64 = run(cfg, counting_flips(plain_f64, flips, "plain_f64"))
    log(f"{tag}: bf16 C' values rounded otherwise than the plain version's, over the 5 "
        f"iterations: K1xx {flips['K1xx']:.4%}, the float64-summed plain version "
        f"{flips['plain_f64']:.4%}")
    out = {f"one_ulp_seed{seed}": compare(
        f"the plain version with {share:.4%} of C' moved one ulp (seed {seed}) - the plain "
        "version, bf16, deterministic (printed)", run(cfg, one_ulp_flips(share, seed)),
        plain_bf16, None) for seed in (0, 1)}
    out["f64_plain"] = compare("the float64-summed plain version - the plain version, bf16, "
                               "deterministic (printed)", f64, plain_bf16, None)
    out["k1xx_f64"] = compare("K1xx's run - the float64-summed plain version's, bf16, "
                              "deterministic (printed)", fused_bf16, f64, None)
    return out


def run_route_check() -> dict:
    """M: K1xx's route inside the pipeline, a check of the route and not a
    user's configuration (no configuration of the repo has more than 1024
    labels): a 160x1280 pair at 1100 labels with bf16 state and the fused
    update, calibrated as L: 5 launches of K1xx and none of the other
    kernels, a finite disparity, within BF16_MEAN_TOL of the same run with
    K1xx's plain version in its place, the fused loop within DISP_ATOL of
    the unfused one in float32; beside the bf16 gate, what rounding alone
    does to it (`rounding_witness`); the warm pipeline, K1xx's share of one
    profile, peak memory."""
    from depth_estimation_torch.data.synthetic import make_stereo_pair
    from depth_estimation_torch.models import pipeline as P
    from depth_estimation_torch.models.pipeline import crf_stereo_infer
    from depth_estimation_torch.ops.cuda.meanfield import (fused_energy_update,
                                                           fused_energy_update_reference)
    from depth_estimation_torch.tools.bench_suite import lattice_cfg

    tag = (f"M (K1xx's route, {ROUTE_H}x{ROUTE_W}, L={ROUTE_LABELS}, bf16, fused; a check of "
           "the route, not a user's configuration)")
    left, right, _ = make_stereo_pair(np.random.RandomState(0), ROUTE_H, ROUTE_W, num_layers=6,
                                      max_disp=ROUTE_LABELS - 2)
    left, right = left.astype(np.float32), right.astype(np.float32)
    t0 = time.perf_counter()
    cfg = lattice_cfg(ROUTE_LABELS, left, DEV)
    calib_s = time.perf_counter() - t0
    log(f"{tag}: calibrated in {calib_s:.2f} s: tiled={cfg.tile_px is not None} tile_px="
        f"{cfg.tile_px} tile_u={cfg.tile_u} max_vertices={cfg.max_vertices} sort_mode="
        f"{cfg.sort_mode} tile_bf16={cfg.tile_bf16}")

    # the main path: launch counts read from zero just around one run
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = crf_stereo_infer(left, right, cfg, device=DEV)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: first run {first_s:.2f} s; launches in one run: {got}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    k1xx = only_launched("K1xx", NITERS)
    plan = out["plans"][0]
    overflow = 0 if plan.tile_overflow is None else int(plan.tile_overflow)
    check(overflow == 0 and int(plan.num_valid) <= cfg.max_vertices, "capacity overflow")
    disp = out["disparity"]
    check(disp.shape == (ROUTE_H, ROUTE_W) and disp.device.type == DEV,
          "disparity shape or device")
    check(bool(torch.isfinite(disp).all()), "non-finite disparity")
    del out, plan, disp

    def run(c, update=None):
        if update is not None:
            P.fused_energy_update = update
        try:
            return crf_stereo_infer(left, right, c, device=DEV)["disparity"].float().cpu()
        finally:
            P.fused_energy_update = fused_energy_update

    def compare(what, a, b, tol, mean=False):
        d = (a - b).abs()
        log(f"{tag}: |{what}| max {float(d.max()):.3g} px, mean {float(d.mean()):.3g} px, "
            f"{int((d > 0).sum())} of {d.numel()} pixels differ"
            + ("" if tol is None else f" (gate: {'mean' if mean else 'max'} <= {tol})"))
        if tol is not None:
            check(float(d.mean() if mean else d.max()) <= tol, f"{what} over {tol} px")
        return float(d.mean()), float(d.max())

    # as in K and L: the bf16 state against the same run with the plain
    # version in K1xx's place, the fused f32 loop against the unfused one
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        flips = {}
        fused_bf16 = run(cfg, counting_flips(fused_energy_update, flips, "K1xx"))
        plain_bf16 = run(cfg, fused_energy_update_reference)
        diffs = {"plain_bf16": compare("K1xx's run - the plain version's in its place, bf16, "
                                       "deterministic", fused_bf16, plain_bf16, BF16_MEAN_TOL,
                                       mean=True)}
        diffs.update(rounding_witness(tag, run, compare, cfg, fused_bf16, plain_bf16, flips))
        cf = replace(cfg, compute_dtype="f32")
        zero_launches()
        fused_f32 = run(cf)
        f32_launches = only_launched("K1xx", NITERS)
        diffs["unfused_f32"] = compare("fused f32 run - the unfused f32 loop, deterministic",
                                       fused_f32, run(replace(cf, fused_update=False)), DISP_ATOL)
    finally:
        torch.use_deterministic_algorithms(False)

    crf_stereo_infer(left, right, cfg, device=DEV)  # warm-up
    ms = median_ms(lambda: crf_stereo_infer(left, right, cfg, device=DEV), 3)
    log(f"{tag}: warm pipeline {ms:.3f} ms with K1xx (median of 3, CUDA events)")
    busy_ms, k1xx_ms = profile(f"pipeline {tag}",
                               lambda: crf_stereo_infer(left, right, cfg, device=DEV),
                               share_of="fused_energy_update_xxwide")
    return {"launches_k1xx": k1xx, "launches": got, "launches_k1xx_f32": f32_launches, "ms": ms,
            "c_flip_share": flips, "device_busy_ms": busy_ms, "k1xx_device_ms": k1xx_ms,
            "k1xx_share": k1xx_ms / busy_ms if busy_ms else None, "first_s": first_s,
            "calibrate_s": calib_s, "tile_px": cfg.tile_px, "tile_u": cfg.tile_u,
            "max_vertices": cfg.max_vertices, "sort_mode": cfg.sort_mode, "peak_bytes": peak,
            "mean_max_abs_diff": diffs}


# ---------------------------------------------------------------------------
# N: the entry points of depth_estimation_torch.tools
# ---------------------------------------------------------------------------


def check_stage_split(tag: str, res: dict, kernel: str, cfg, epe_direct: float) -> dict:
    """Every stage of a `profile_stages` line timed finite and positive;
    its configuration the phase's (capacity, sort mode, tiles, state
    dtype) with no vertex dropped; its pipeline stage launching `kernel` 5
    times a call and no other fused-update kernel (the tool's own count per
    call, and the counts since `zero_launches`); its pipeline's EPE within
    BF16_MEAN_TOL of the same configuration's run outside the tool."""
    from depth_estimation_torch.tools.profile_stages import STAGES

    ms = {name: res[f"{name}_ms"] for name in STAGES}
    check(all(np.isfinite(v) and v > 0 for v in ms.values()), f"{tag}: stage times {ms}")
    want = {"capacity": cfg.max_vertices, "sort_mode": cfg.sort_mode,
            "tile_px": cfg.tile_px, "tile_u": cfg.tile_u if cfg.tile_px else None,
            "tiled": (2 if cfg.tile_bf16 else 1) if cfg.tile_px else 0,
            "compute_dtype": cfg.compute_dtype}
    got_cfg = {k: res[k] for k in want}
    check(got_cfg == want, f"{tag}: the tool's configuration {got_cfg}, the phase's {want}")
    check(res["num_valid"] <= res["capacity"] and not res["tile_overflow"],
          f"{tag}: {res['num_valid']} vertices for {res['capacity']} slots, "
          f"{res['tile_overflow']} tile entries dropped")
    per_call = res["pipeline_launches_per_call"]
    check(per_call == {k: float(NITERS) if k == kernel else 0.0 for k in per_call},
          f"{tag}: launches per pipeline call {per_call}, want {NITERS} of {kernel}")
    got = launches()
    check(got[kernel] > 0 and all(v == 0 for k, v in got.items() if k != kernel),
          f"{tag}: launches {got}")
    check(abs(res["pipeline_epe"] - epe_direct) <= BF16_MEAN_TOL,
          f"{tag}: the tool's pipeline EPE {res['pipeline_epe']}, the direct run's {epe_direct}")
    order = sorted(ms, key=ms.get, reverse=True)
    log(f"{tag}: stage ms " + ", ".join(f"{k} {ms[k]:.3f}" for k in STAGES))
    log(f"{tag}: stages by time {order}; {kernel} launched {got[kernel]} times "
        f"({per_call[kernel]:.0f} a pipeline call); capacity {res['capacity']}, "
        f"{res['num_valid']} vertices occupied; pipeline EPE {res['pipeline_epe']:.4f} px "
        f"(the direct run {epe_direct:.4f} px), bad-2 {res['pipeline_bad2']:.4f}")
    return {"stage_ms": ms, "order": order, "launches_per_call": per_call[kernel],
            "launches": got[kernel], "capacity": res["capacity"], "num_valid": res["num_valid"],
            "pipeline_epe": res["pipeline_epe"], "direct_epe": epe_direct}


def stage_split_cases() -> list:
    """(tag, pair, ground truth, config, kernel) of N1-N3: phase A's,
    K's and L's pairs, each calibrated as its phase calibrates it, in bf16
    state with the fused update."""
    from depth_estimation_torch.data.synthetic import make_stereo_pair
    from depth_estimation_torch.models.pipeline import CRFStereoConfig, calibrate_capacity
    from depth_estimation_torch.tools.bench_suite import lattice_cfg

    a_left, a_right, a_gt = synthetic_pair(0.5)
    a_cfg = calibrate_capacity(a_left, CRFStereoConfig(num_disp=LABELS, niters=NITERS),
                               tiled=True, tile_px=TILE_PX, device=DEV)
    a_cfg = replace(a_cfg, tile_bf16=True)
    k_left, k_right, k_gt = make_stereo_pair(np.random.RandomState(0), FULL_H, FULL_W,
                                             num_layers=6, max_disp=FULL_MAX_DISP)
    l_left, l_right, l_gt = make_stereo_pair(np.random.RandomState(0), MID_H, MID_W,
                                             num_layers=6, max_disp=MID_LABELS - 2)
    cases = [("N1 (A's pair and configuration)", (a_left, a_right), a_gt, a_cfg, "K1"),
             ("N2 (K's pair and configuration)", (k_left, k_right), k_gt,
              lattice_cfg(FULL_LABELS, k_left.astype(np.float32), DEV), "K1w"),
             ("N3 (L's pair and configuration)", (l_left, l_right), l_gt,
              lattice_cfg(MID_LABELS, l_left.astype(np.float32), DEV), "K1x")]
    return [(tag, pair, gt, replace(cfg, compute_dtype="bf16", fused_update=True), kernel)
            for tag, pair, gt, cfg, kernel in cases]


def stage_split_argv(cfg, pair_path: str, reps: int) -> list[str]:
    """The `profile_stages` flags of `cfg` on the pair saved at `pair_path`."""
    argv = ["--pair", pair_path, "--labels", str(cfg.num_disp),
            "--max-vertices", str(cfg.max_vertices), "--sort-mode", cfg.sort_mode,
            "--compute-dtype", cfg.compute_dtype, "--fused-update", "1", "--reps", str(reps)]
    if cfg.tile_px:
        argv += ["--tiled", "2" if cfg.tile_bf16 else "1", "--tile-px", str(cfg.tile_px),
                 "--tile-u", str(cfg.tile_u)]
    return argv


def steady_ms(step_ms: list) -> float:
    """The median step time after the first N_WARM_STEPS of a phase."""
    return statistics.median(step_ms[N_WARM_STEPS:])


def run_tools() -> dict:
    """N: the four entry points of `depth_estimation_torch.tools`, called
    in-process as a user calls them from the command line, on the card:
    the per-stage profiler on A's, K's and L's pairs in their phases'
    configurations with the fused update (K1, K1w and K1x), the tiled
    stereo's one-rank timing at 994x1482, L = 64, and the two scaled
    detection runs. Each runs with the launch counts set to 0 just before
    it and read just after."""
    import tempfile

    from depth_estimation_torch.models.pipeline import crf_stereo_infer
    from depth_estimation_torch.tools import (profile_stages, tiled_stereo_study,
                                              train_coco_scaled, train_detect_scaled)
    from depth_estimation_torch.train.metrics import epe

    TOOLS_OUT.mkdir(exist_ok=True)
    log(f"N: the tools' entry points on {card_line()}")
    out = {}
    for tag, pair, gt, cfg, kernel in stage_split_cases():
        left, right, gt = (x.astype(np.float32) for x in (*pair, gt))
        g = torch.as_tensor(gt, device=DEV)
        direct = crf_stereo_infer(left, right, cfg, device=DEV)["disparity"]
        epe_direct = float(epe(direct, g, (g > 0).float()))
        del direct, g
        reps = N1_REPS if kernel == "K1" else N_WIDE_REPS
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/pair.npz"
            np.savez(path, left=left, right=right, disparity=gt)
            argv = stage_split_argv(cfg, path, reps)
            zero_launches()
            t0 = time.perf_counter()
            res = profile_stages.main(
                argv + ["--out", str(TOOLS_OUT / f"profile_stages_{tag[:2]}.json")])
            wall = time.perf_counter() - t0
        shown = " ".join(a for a in argv if a != path)
        out[tag[:2]] = check_stage_split(f"{tag} profile_stages {shown}", res, kernel, cfg,
                                         epe_direct)
        out[tag[:2]]["wall_s"] = wall
        log(f"{tag[:2]}: {wall:.1f} s in all")
    log("N2, N3: phase K's and L's profiles above put the untiled splat's products and "
        f"index_add_ first, then the blur; the stage split orders N2 {out['N2']['order']}, "
        f"N3 {out['N3']['order']}")

    zero_launches()
    res = tiled_stereo_study.main(["--mode", "time", "--halo", "16", "--reps", "4",
                                   "--out", str(TOOLS_OUT / "tiled_stereo_N4.json")])
    check(all(v == 0 for v in launches().values()), f"N4 launched {launches()}")
    log(f"N4 tiled_stereo_study --mode time ({res['unit']}, {res['backend']}): untiled "
        f"{res['untiled_ms']:.3f} ms, tiled on one rank {res['tiled_1chip_ms']:.3f} ms, "
        f"overhead {res['overhead_pct']:.2f}%")
    log(f"N4: two untiled runs differ by up to {res['untiled_repeat_max_abs_disp_delta']:.3g} px "
        "(index_add_'s order); in deterministic mode the one-tile map against the untiled one: "
        "halo 0 max "
        f"{res['one_tile_halo0_max_abs_disp_delta']:.3g} px; halo 16 (zero rows padded at the "
        f"frame's edges) max {res['one_tile_max_abs_disp_delta']:.3g} px, mean "
        f"{res['one_tile_mean_abs_disp_delta']:.3g} px, {res['one_tile_rows_over_5e-3px']} rows "
        "over 5e-3 px")
    ulp_max = res["cpu_one_ulp_max_abs_disp_delta"]
    log(f"N4: the one-tile map at halo 16 against the same call on the CPU: max "
        f"{res['one_tile_cpu_max_abs_disp_delta']:.3g} px, mean "
        f"{res['one_tile_cpu_mean_abs_disp_delta']:.3g} px; one rounding of the left image "
        f"moves the CPU's map by up to {ulp_max:.3g} px, mean "
        f"{res['cpu_one_ulp_mean_abs_disp_delta']:.3g} px")
    check(res["one_tile_halo0_max_abs_disp_delta"] <= DISP_ATOL,
          "N4: the one-tile map at halo 0 is off the untiled one")
    check(res["one_tile_cpu_mean_abs_disp_delta"] <= F32_MEAN_TOL,
          f"N4: the one-tile map at halo 16 is over {F32_MEAN_TOL} px (mean) off the CPU's")
    check(res["one_tile_cpu_max_abs_disp_delta"] <= DISP_ATOL + ulp_max,
          f"N4: the one-tile map at halo 16 is off the CPU's by more than {DISP_ATOL} px plus "
          "what one rounding of the input moves the CPU's map")
    out["N4"] = res

    zero_launches()
    res = train_detect_scaled.main(["--steps", str(N5_STEPS),
                                    "--out", str(TOOLS_OUT / "detect_scaled_N5.json")])
    check(all(v == 0 for v in launches().values()), f"N5 launched {launches()}")
    check(res["losses_finite"], "N5: a non-finite loss")
    check(res["heads_phase_body_unchanged"] is True, "N5: the heads phase moved the grafted body")
    check(res["params_unmoved_last_phase"] == [],
          f"N5: unmoved in the all-layers phase: {res['params_unmoved_last_phase']}")
    steady = {k: steady_ms(v) for k, v in res["step_ms"].items()}
    log(f"N5 train_detect_scaled --steps {N5_STEPS}: step ms (host clock, each step ending on "
        f"its loss) heads {res['step_ms']['heads']}, all layers {res['step_ms']['all']}; median "
        f"after the first {N_WARM_STEPS} of a phase: heads {steady['heads']:.3f}, all layers "
        f"{steady['all']:.3f}; held-out mAP@0.5 {res['heldout_map50']:.4f}, mask IoU "
        f"{res['heldout_mask_iou']:.4f} (not gated); wall {res['wall_s']:.1f} s")
    out["N5"] = {k: res[k] for k in ("step_ms", "heldout_map50", "heldout_mask_iou",
                                     "loss_first", "loss_last", "wall_s")}
    out["N5"]["steady_step_ms"] = steady

    zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        res = train_coco_scaled.main(["--steps", str(N6_STEPS), "--items", str(N6_ITEMS),
                                      "--holdout", str(N6_HOLDOUT), "--data-dir", tmp,
                                      "--out", str(TOOLS_OUT / "coco_scaled_N6.json")])
    check(all(v == 0 for v in launches().values()), f"N6 launched {launches()}")
    check(res["items_read"] == N6_ITEMS, f"N6: {res['items_read']} items read back")
    check(res["losses_finite"], "N6: a non-finite loss")
    steady = steady_ms(res["step_ms"])
    log(f"N6 train_coco_scaled --steps {N6_STEPS} --items {N6_ITEMS}: {res['items_read']} items "
        f"read back, step ms {res['step_ms']} (host clock); median after the first "
        f"{N_WARM_STEPS}: {steady:.3f}; wall {res['wall_s']:.1f} s")
    out["N6"] = {k: res[k] for k in ("items_read", "step_ms", "loss_first", "loss_last",
                                     "wall_s")}
    out["N6"]["steady_step_ms"] = steady
    log(card_line())
    return out


def run_bench_line(tag: str, argv: list[str]) -> dict:
    """`bench_torch.py` in a process of its own, as a user runs it: its
    line with `bench.py`'s keys, the card's name, a roofline fraction in
    (0, 1], K1 5 times a pipeline call and no other kernel, no vertex
    dropped (its standard error's record)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"{tag}: bench_torch.py exited {res.returncode}:\n"
          + res.stderr[-3000:])
    line = json.loads(res.stdout.strip().splitlines()[-1])
    info = json.loads(next(x for x in res.stderr.splitlines() if x.startswith("{")))
    d = line["detail"]
    log(f"{tag} bench_torch.py {' '.join(argv)} ({wall:.1f} s): {json.dumps(line)}")
    log(f"{tag}: {json.dumps(info)}")
    check(tuple(line) == BENCH_KEYS and tuple(d) == BENCH_DETAIL_KEYS, f"{tag}: keys {line}")
    check(d["device"] == torch.cuda.get_device_name(0), f"{tag}: device {d['device']}")
    check(d["roofline_fraction"] is not None and 0 < d["roofline_fraction"] <= 1.0,
          f"{tag}: roofline fraction {d['roofline_fraction']}")
    per_call = info["launches_per_call"]
    check(per_call == {k: NITERS if k == "K1" else 0 for k in per_call},
          f"{tag}: launches a pipeline call {per_call}")
    check(info["num_valid"] <= d["max_vertices"] and not info["tile_overflow"],
          f"{tag}: {info['num_valid']} vertices for {d['max_vertices']}, "
          f"{info['tile_overflow']} tile entries dropped")
    return {"line": line, **info, "wall_s": wall}


def check_dense_oracle(line: dict) -> dict:
    """tsukuba_dense's pair through the dense oracle on the card in
    float32 (TF32 off) against the same pipeline in float64 (the images
    taken as float64, so that every stage before the decode runs in it),
    within DISP_ATOL plus what one float32 rounding of the left image moves
    the float32 map (printed beside); one float32 run profiled."""
    from depth_estimation_torch.models import pipeline as P
    from depth_estimation_torch.tools.bench_suite import flagship_pair

    left, right = flagship_pair(False, DEV)
    check((line["h"], line["w"]) == tuple(left.shape[:2]), f"dense pair {tuple(left.shape)}")
    cfg = P.CRFStereoConfig(num_disp=16, niters=NITERS, backend="dense")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

    def run(x):
        return P.crf_stereo_infer(x, right, cfg, device=DEV)["disparity"].double().cpu()

    f32, f32_ulp = run(left), run(left * (1 + torch.finfo(torch.float32).eps))
    as_image = P._as_image
    P._as_image = lambda x, device: torch.as_tensor(x).to(device=device, dtype=torch.float64)
    try:
        f64 = run(left.double())
    finally:
        P._as_image = as_image
    diff, ulp = (f32 - f64).abs(), (f32_ulp - f32).abs()
    busy_ms = profile("O tsukuba_dense (one float32 pipeline)",
                      lambda: P.crf_stereo_infer(left, right, cfg, device=DEV))
    log(f"O tsukuba_dense: |float32 map (TF32 off) - float64 map| max {float(diff.max()):.3g} px, "
        f"mean {float(diff.mean()):.3g} px; one rounding of the left image moves the float32 map "
        f"by up to {float(ulp.max()):.3g} px, mean {float(ulp.mean()):.3g} px")
    check(float(diff.max()) <= DISP_ATOL + float(ulp.max()),
          f"tsukuba_dense: the float32 map is off the float64 one by more than {DISP_ATOL} px "
          "plus what one rounding of the input moves it")
    return {"device_busy_ms": busy_ms,
            "f64_max_abs_diff": float(diff.max()), "f64_mean_abs_diff": float(diff.mean()),
            "within_disp_atol": float(diff.max()) <= DISP_ATOL,
            "one_ulp_max_abs_diff": float(ulp.max()), "one_ulp_mean_abs_diff": float(ulp.mean())}


def check_middlebury_kernel(line: dict) -> dict:
    """middlebury64's configuration on the card with K1 and with K1's plain
    version in its place, both in deterministic mode: bf16 maps within
    BF16_MEAN_TOL (mean)."""
    from depth_estimation_torch.models import pipeline as P
    from depth_estimation_torch.ops.cuda.meanfield import (fused_energy_update,
                                                           fused_energy_update_reference)
    from depth_estimation_torch.tools import bench_suite

    h, w, L = bench_suite.FULL["middlebury64"]
    left, right, _ = bench_suite.natural_pair(h, w, L - 2, DEV)
    cfg = bench_suite.lattice_cfg(L, left, DEV)
    check(cfg.max_vertices == line["max_vertices"], f"middlebury64 calibrates to {cfg}")

    def run(update):
        P.fused_energy_update = update
        try:
            return P.crf_stereo_infer(left, right, cfg, device=DEV)["disparity"].float().cpu()
        finally:
            P.fused_energy_update = fused_energy_update

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        zero_launches()
        fused = run(fused_energy_update)
        check(launches()["K1"] == NITERS, f"middlebury64's fused run launched {launches()}")
        plain = run(fused_energy_update_reference)
    finally:
        torch.use_deterministic_algorithms(False)
    d = (fused - plain).abs()
    log(f"O middlebury64 ({h}x{w}, L={L}, tile_px={cfg.tile_px}, tile_u={cfg.tile_u}, "
        f"sort_mode={cfg.sort_mode}): |K1's bf16 map - the plain version's in its place| "
        f"(deterministic) max {float(d.max()):.3g} px, mean {float(d.mean()):.3g} px, "
        f"{int((d > 0).sum())} of {d.numel()} pixels differ")
    check(float(d.mean()) <= BF16_MEAN_TOL, f"middlebury64: K1 against its plain version, mean "
          f"{float(d.mean())} px")
    return {"plain_max_abs_diff": float(d.max()), "plain_mean_abs_diff": float(d.mean()),
            "tile_px": cfg.tile_px, "tile_u": cfg.tile_u, "sort_mode": cfg.sort_mode}


def run_benchmarks(a: dict, k: dict) -> dict:
    """O: the benchmark programs as a user calls them: `bench_torch.py` in a
    process of its own on its defaults and on A's pair (`--pair`, with
    `--dense-baseline`), whose calibration must be A's; the five
    configurations of `tools.bench_suite` at full size in-process, each
    between `zero_launches` and `launches` (K1 5 a call in middlebury64,
    K1w 5 in fullres128, K1 40 a batch in serving_batched, none in
    tsukuba_dense and trainable_step), with the dense oracle's float32 map
    against its float64 one, middlebury64's occupancy and K1 against its
    plain version, fullres128 within FULLRES_REL_TOL of K's warm run; and
    `tools.bench_scaling` on this card (size 1)."""
    import tempfile

    from depth_estimation_torch.tools import bench_scaling, bench_suite

    TOOLS_OUT.mkdir(exist_ok=True)
    log(f"O: the benchmark programs on {card_line()}")
    out = {}
    t_phase = time.perf_counter()
    out["O1"] = run_bench_line("O1", ["--reps", str(BENCH_REPS)])
    a_left, a_right, _ = synthetic_pair(0.5)
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/a.npz", left=a_left, right=a_right)
        out["O2"] = run_bench_line("O2", ["--reps", str(BENCH_REPS), "--pair", f"{tmp}/a.npz",
                                          "--dense-baseline"])
    d = out["O2"]["line"]["detail"]
    got = {key: d[key] for key in ("max_vertices", "tile_px", "tile_u", "sort_mode")}
    want = {"max_vertices": a["max_vertices"], "tile_px": TILE_PX, "tile_u": a["tile_u"],
            "sort_mode": a["sort_mode"]}
    check(got == want, f"O2: the bench's configuration on A's pair {got}, A's {want}")
    check(d["vs_baseline_source"] == "dense oracle measured live"
          and out["O2"]["line"]["vs_baseline"] > 1.0, f"O2: vs_baseline {out['O2']['line']}")

    for i, name in enumerate(bench_suite.CONFIGS, 1):
        zero_launches()
        t0 = time.perf_counter()
        line, = bench_suite.main(["--configs", str(i), "--reps", str(SUITE_REPS),
                                  "--out", str(TOOLS_OUT / f"bench_suite_{name}_O.json")])
        wall = time.perf_counter() - t0
        got = launches()
        keys = SUITE_KEYS[name]
        check(tuple(line)[:len(keys)] == keys, f"O {name}: keys {list(line)}")
        check(line["device"] == torch.cuda.get_device_name(0) and np.isfinite(line["value"])
              and line["value"] > 0, f"O {name}: {line}")
        want = {kn: SUITE_LAUNCHES[name].get(kn, 0) for kn in got}
        check(line["launches_per_call"] == want
              and all((got[kn] > 0) == (want[kn] > 0) for kn in got),
              f"O {name}: launches a call {line['launches_per_call']}, in the run {got}; want "
              f"{want} a call")
        log(f"O {name} ({wall:.1f} s; launches in the run {got}): {json.dumps(line)}")
        res = {"line": line, "launches": got, "wall_s": wall}
        if "num_valid" in line:
            check(line["num_valid"] <= line["max_vertices"] and not line["tile_overflow"],
                  f"O {name}: {line['num_valid']} vertices for {line['max_vertices']}, "
                  f"{line['tile_overflow']} tile entries dropped")
        if name == "tsukuba_dense":
            check(line["allow_tf32"] is False, "tsukuba_dense ran with TF32")
            res.update(check_dense_oracle(line))
        elif name == "middlebury64":
            res.update(check_middlebury_kernel(line))
        elif name == "fullres128":
            rel = line["pipeline_ms"] / k["chain_ms"] - 1.0
            log(f"O fullres128: pipeline {line['pipeline_ms']:.3f} ms, K's warm run "
                f"{k['chain_ms']:.3f} ms a call by the same timer in this call ({100 * rel:+.2f}%; "
                f"K's median of single calls {k['ms']:.3f} ms)")
            check(abs(rel) <= FULLRES_REL_TOL, f"fullres128 {100 * rel:+.2f}% off K's warm run")
            res["rel_to_k"] = rel
        out[name] = res

    zero_launches()
    t0 = time.perf_counter()
    res = bench_scaling.main(["--out", str(TOOLS_OUT / "bench_scaling_O.json")])
    wall = time.perf_counter() - t0
    log(f"O bench_scaling ({wall:.1f} s): {json.dumps(res)}")
    cards = torch.cuda.device_count()
    check(tuple(res) == SCALING_KEYS, f"bench_scaling keys {list(res)}")
    check(all(int(c) <= cards for c in res["frames_per_s"]) and res["frames_per_s"]["1"] > 0
          and res["efficiency_vs_linear"]["1"] == 1.0, f"bench_scaling {res}")
    check(cards > 1 or "one card" in (res["note"] or ""), f"bench_scaling's note {res['note']}")
    check(all(v == 0 for v in launches().values()), f"bench_scaling launched {launches()}")
    out["scaling"] = {**res, "wall_s": wall}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"O: {out['wall_s']:.1f} s in all; {card_line()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from depth_estimation_torch.ops.cuda import meanfield as K
    from depth_estimation_torch.utils.build import build_all

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # plain versions on the card compute float32 products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(K)
    native_err = check_native()

    log("fused_energy_update against its plain version (K1 at L in "
        f"{K.SUPPORTED_L}, K1w at every other L up to {K.WIDE_MAX_L}, K1x up to "
        f"{K.XWIDE_MAX_L}, K1xx above):")
    n, n_full, n_mid = H * W, FULL_H * FULL_W, MID_H * MID_W
    errs = {}
    for rows, L in ((n, LABELS), (n - 7, LABELS), (n, 8), (n, 32), (n, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            errs[rows, L, dtype] = check_fused_update(K, rows, L, dtype)
    for L in WIDE_CHECK_L + WIDE_EDGE_L + XWIDE_CHECK_L + (K.XWIDE_MAX_L,) + XXWIDE_CHECK_L:
        for rows in (n, n - 7):
            for dtype in (torch.float32, torch.bfloat16):
                errs[rows, L, dtype] = check_fused_update(K, rows, L, dtype)
    for dtype in (torch.float32, torch.bfloat16):  # K1xx at a label count off every pad
        errs[XXWIDE_ODD_L, XXWIDE_ODD_L, dtype] = check_fused_update(K, XXWIDE_ODD_L, XXWIDE_ODD_L,
                                                                     dtype)
    for dtype in (torch.float32, torch.bfloat16):  # K1w, K1x and K1xx at their phases' shapes
        errs[n_full, FULL_LABELS, dtype] = check_fused_update(K, n_full, FULL_LABELS, dtype,
                                                              on_device=True)
        errs[n_mid, MID_LABELS, dtype] = check_fused_update(K, n_mid, MID_LABELS, dtype,
                                                            on_device=True)
        errs[XX_N, XX_LABELS, dtype] = check_fused_update(K, XX_N, XX_LABELS, dtype,
                                                          on_device=True)
        errs[ROUTE_H * ROUTE_W, ROUTE_LABELS, dtype] = check_fused_update(
            K, ROUTE_H * ROUTE_W, ROUTE_LABELS, dtype, on_device=True)
    # K1xx at phase L's shape, launched directly, to weigh it against K1x there
    errs_xx_mid = {dtype: check_fused_update(K, n_mid, MID_LABELS, dtype, on_device=True,
                                             kernel="K1xx")
                   for dtype in (torch.float32, torch.bfloat16)}
    t_bf16 = time_fused_update(K, n, LABELS, torch.bfloat16)
    t_f32 = time_fused_update(K, n, LABELS, torch.float32)
    t_wide = {f"{dt}_L{L}": time_fused_update(K, n, L, dtype) for L in (32, 64)
              for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    # K1 at the state of the JAX bench suite's middlebury64 config (994x1482, L = 64)
    t_mid64 = {dt: time_fused_update(K, n_mid, 64, dtype, on_device=True)
               for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    w_full = {dt: time_fused_update(K, n_full, FULL_LABELS, dtype, on_device=True)
              for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    # K1w at the ends of its range, on fullres128's rows
    w_by_L = {f"K1w_L{L}_{dt}": time_fused_update(K, n_full, L, dtype, on_device=True)
              for L in (24, 256) for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    w_flagship = {dt: time_fused_update(K, n, FULL_LABELS, dtype)
                  for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    # K1x at phase L's shape; and beside K1w at 256
    x_mid = {dt: time_fused_update(K, n_mid, MID_LABELS, dtype, on_device=True)
             for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    x_256 = {dt: time_fused_update(K, n_full, 256, dtype, on_device=True, kernel="K1x")
             for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    # K1xx at (393216, 1536), and its plain version
    xx = {dt: time_fused_update(K, XX_N, XX_LABELS, dtype, on_device=True,
                                plain_reps=XX_SLOW_REPS)
          for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    # K1xx at phase L's shape, on the inputs K1x is timed on there
    xx_mid = {dt: time_fused_update(K, n_mid, MID_LABELS, dtype, on_device=True, kernel="K1xx")
              for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    log("the lattice apply's splat and slice kernels against their plain versions:")
    lat = time_lattice_apply()
    log("the stereo cost volume's kernel against float64 and its plain version:")
    cvol = time_cost_volume()

    a = run_pipeline("A (bench configuration, lean plan, bf16)", 0.5,
                     dict(tile_bf16=True, compute_dtype="bf16"), "packed1", f32=False)
    b = run_pipeline("B (general tiled plan, f32)", 1.0, {}, "auto", f32=True)
    c = run_trainable_step()
    d = run_train_tsukuba()
    f = run_serving()
    g = run_world()
    h = run_operators()
    i = run_detection()
    j = run_detection_training()
    k = run_fullres()
    wd = run_wide_disparity()
    m = run_route_check()
    tools = run_tools()
    bench = run_benchmarks(a, k)
    log(json.dumps({"tools": {"N": tools}}))
    log(json.dumps({"benchmarks": {"O": bench}}))
    log(json.dumps({"pipelines": {"A": a, "B": b, "K": k, "L": wd, "M": m}}))
    log(json.dumps({"training": {"C": c, "D": d}}))
    log(json.dumps({"serving": {"F": f}, "world": {"G": g}, "operators": {"H": h}}))
    log(json.dumps({"detection": {"I": i, "J": j}}))
    log(json.dumps({"ptxas": ptxas, "native_lattice_max_abs_err": native_err}))
    log(json.dumps({"geometry": {dt: vars(K.launch_geometry(n, LABELS, elt))
                                 for dt, elt in (("bf16", 2), ("f32", 4))},
                    "geometry_wide": {f"L{L}_{dt}": vars(K.wide_geometry(n_full, L, elt, sms))
                                      for L in WIDE_CHECK_L for dt, elt in (("bf16", 2), ("f32", 4))},
                    "geometry_xwide": {f"L{L}_{dt}": vars(K.xwide_geometry(n_mid, L, elt, sms))
                                       for L in XWIDE_CHECK_L + (K.XWIDE_MAX_L,)
                                       for dt, elt in (("bf16", 2), ("f32", 4))},
                    "geometry_xxwide": {f"L{L}_{dt}": vars(K.xxwide_geometry(XX_N, L, elt, sms))
                                        for L in XXWIDE_CHECK_L + (XXWIDE_ODD_L,)
                                        for dt, elt in (("bf16", 2), ("f32", 4))}}))

    k1 = {
        "name": "fused_energy_update", "route": "cuda",
        "source": "depth_estimation_torch/csrc/meanfield.cu",
        "replaces": "depth_estimation_tpu/ops/pallas/meanfield.py:56",
        "launches": a["launches"], "max_abs_err": errs[n, LABELS, torch.bfloat16],
        **t_bf16, "library_ms": None,
        "us": t_bf16["ms"] * 1e3, "bound_us": t_bf16["bound_ms"] * 1e3,
        "shape": [n, LABELS], "dtype": "bf16", "launches_b": b["launches"],
        "launches_f": f["launches"], "launches_k": k["launches_k1"],
        "launches_n1": tools["N1"]["launches"],
        "max_abs_err_f32": errs[n, LABELS, torch.float32],
        "f32": t_f32, **t_wide, f"n{n_mid}_L64": t_mid64,
        "design": "a warp per tile of rows, coalesced 16-byte loads, Mu in registers",
    }
    k1w = {
        "name": "fused_energy_update_wide", "route": "cuda",
        "source": "depth_estimation_torch/csrc/meanfield_wide.cu",
        "replaces": "depth_estimation_tpu/ops/pallas/meanfield.py:56",
        "launches": k["launches_k1w"],
        "max_abs_err": errs[n_full, FULL_LABELS, torch.bfloat16],
        **w_full["bf16"], "library_ms": None,
        "us": w_full["bf16"]["ms"] * 1e3, "bound_us": w_full["bf16"]["bound_ms"] * 1e3,
        "shape": [n_full, FULL_LABELS], "dtype": "bf16",
        "launches_crop_f32": k["crop_launches_k1w"], "launches_n2": tools["N2"]["launches"],
        "max_abs_err_f32": errs[n_full, FULL_LABELS, torch.float32],
        "f32": w_full["f32"], f"n{n}_L{FULL_LABELS}": w_flagship,
        "max_abs_err_by_L": {f"L{L}_{str(dt)[6:]}": max(errs[n, L, dt], errs[n - 7, L, dt])
                             for L in WIDE_CHECK_L + WIDE_EDGE_L
                             for dt in (torch.float32, torch.bfloat16)},
        "k_device_share": k["k1w_share"], "by_L_n2088960": w_by_L,
        "design": "persistent blocks with Mu in shared memory, a warp per tile of rows, "
                  "E0/S/C staged by 16-byte cp.async during the previous tile's product; bf16: "
                  "softmax in the registers of a tensor-core product (mma.sync) with q split "
                  "into bf16 hi+lo, 16-byte stores; f32: the plain version's arithmetic bit "
                  "for bit (PyTorch's warp-softmax order, in-order FFMA sum)",
    }
    k1x = {
        "name": "fused_energy_update_xwide", "route": "cuda",
        "source": "depth_estimation_torch/csrc/meanfield_xwide.cu",
        "replaces": "depth_estimation_tpu/ops/pallas/meanfield.py:56",
        "launches": wd["launches_k1x"], "max_abs_err": errs[n_mid, MID_LABELS, torch.bfloat16],
        **x_mid["bf16"], "library_ms": None,
        "us": x_mid["bf16"]["ms"] * 1e3, "bound_us": x_mid["bf16"]["bound_ms"] * 1e3,
        "shape": [n_mid, MID_LABELS], "dtype": "bf16",
        "launches_crop_f32": wd["crop_launches_k1x"], "launches_n3": tools["N3"]["launches"],
        "max_abs_err_f32": errs[n_mid, MID_LABELS, torch.float32], "f32": x_mid["f32"],
        "max_abs_err_by_L": {f"L{L}_{str(dt)[6:]}": max(errs[n, L, dt], errs[n - 7, L, dt])
                             for L in XWIDE_CHECK_L + (K.XWIDE_MAX_L,)
                             for dt in (torch.float32, torch.bfloat16)},
        "l_device_share": wd["k1x_share"], f"n{n_full}_L256": x_256,
        "design": "a persistent warp-specialised block a SM: producer warps write E and q (f32) "
                  "of a tile of rows into one of two shared-memory buffers, the next rows loaded "
                  "into registers meanwhile; consumer warps stream Mu's stage images by bulk copy "
                  "(TMA) through a ring; bf16: wgmma m64n160k16 with q split into three bf16 "
                  "terms in registers (setmaxnreg); f32: the plain version's arithmetic "
                  "(warp-softmax order, in-order FFMA sum)",
    }
    k1xx = {
        "name": "fused_energy_update_xxwide", "route": "cuda",
        "source": "depth_estimation_torch/csrc/meanfield_xxwide.cu",
        "replaces": "depth_estimation_tpu/ops/pallas/meanfield.py:56",
        # launches and max_abs_err at phase M's shape (204800, 1100); the
        # times at (393216, 1536)
        "launches": m["launches_k1xx"],
        "max_abs_err": errs[ROUTE_H * ROUTE_W, ROUTE_LABELS, torch.bfloat16],
        "max_abs_err_f32": errs[ROUTE_H * ROUTE_W, ROUTE_LABELS, torch.float32],
        "max_abs_err_shape": [ROUTE_H * ROUTE_W, ROUTE_LABELS],
        **xx["bf16"], "library_ms": None,
        "us": xx["bf16"]["ms"] * 1e3, "bound_us": xx["bf16"]["bound_ms"] * 1e3,
        "shape": [XX_N, XX_LABELS], "dtype": "bf16", "launches_f32_run": m["launches_k1xx_f32"],
        f"max_abs_err_n{XX_N}_L{XX_LABELS}": {str(dt)[6:]: errs[XX_N, XX_LABELS, dt]
                                              for dt in (torch.float32, torch.bfloat16)},
        "f32": xx["f32"],
        "max_abs_err_by_L": {f"L{L}_{str(dt)[6:]}": max(errs[n, L, dt], errs[n - 7, L, dt])
                             for L in XXWIDE_CHECK_L for dt in (torch.float32, torch.bfloat16)},
        f"max_abs_err_L{XXWIDE_ODD_L}_n{XXWIDE_ODD_L}": {
            str(dt)[6:]: errs[XXWIDE_ODD_L, XXWIDE_ODD_L, dt]
            for dt in (torch.float32, torch.bfloat16)},
        "m_device_share": m["k1xx_share"],
        # launched directly at phase L's shape, beside K1x there (the k1x entry)
        f"n{n_mid}_L{MID_LABELS}": {**xx_mid, "max_abs_err": {
            str(dt)[6:]: e for dt, e in errs_xx_mid.items()}},
        "design": "a persistent warp-specialised block a SM of 4 producer warps and 2 consumer "
                  "warpgroups (no setmaxnreg): producers write q in chunks of 32 labels into a "
                  "ring of shared-memory stages beside Mu's (32 x 512) tiles, streamed by bulk "
                  "copy (TMA), 512 output columns a pass; bf16: work items (64-row tile, pass) "
                  "so that the blocks on one tile share it in L2, an online softmax (sums "
                  "rescaled where a chunk's max grows), q as three exact bf16 terms, each "
                  "warpgroup wgmma m64n256k16 on its 256 columns with both operands from shared "
                  "memory; f32: work items of a 32-row tile, the plain version's arithmetic "
                  "(warp-softmax order, in-order FFMA sum, 8x8 a thread)",
    }
    lattice = {
        "name": "lattice_splat / lattice_slice", "route": "cuda",
        "source": "depth_estimation_torch/csrc/lattice_apply.cu", "replaces": None,
        "launches_k": k["launches_lattice"], **lat,
        "design": "slice: a team of lanes a pixel gathers its d+1 rows of the L2-resident table, "
                  "the plain version's order with separately rounded products and sums; splat: "
                  "a segmented reduce over the entries sorted by slot, each slot cut into chunks "
                  "of 256 entries, a team a chunk, a second pass adding a slot's chunk sums in "
                  "order (deterministic, no atomics)"}
    costvolume = {
        "name": "costvolume_reflect", "route": "cuda",
        "source": "depth_estimation_torch/csrc/costvolume.cu", "replaces": None,
        "launches_k": k["launches_costvolume"], "launches_crop_k": k["crop_launches_costvolume"],
        "launches_l": wd["launches_costvolume"], "launches_crop_l": wd["crop_launches_costvolume"],
        **cvol,
        "design": "a block a tile of 1024/D - 2r columns, a strip of rows and D <= 32 labels: "
                  "the haloed left tile and right strip staged in shared memory 2r + 1 rows at a "
                  "time, a thread a haloed column and 4 labels forming raw costs into a ring of "
                  "registers and summing the window's rows there, a thread a run of 8 pixels "
                  "summing its columns from shared memory, scaled and stored as 128-byte lines "
                  "of 16-byte words (f32 sums in one fixed order, deterministic)"}
    log(f"chip_smoke: the whole script took {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": [k1, k1w, k1x, k1xx, lattice, costvolume]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
