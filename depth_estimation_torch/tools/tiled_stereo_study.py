"""The row-tiled stereo pipeline (`parallel.stereo_tiled`) measured
(counterpart of the JAX system's `tools/tiled_stereo_study.py`).

Two studies:

  halo  the Tsukuba pair (`DET_TSUKUBA_DIR`) through
        `crf_stereo_infer_tiled` on a world of `--tiles` ranks, one row
        stripe a rank (gloo, which lets ranks share one GPU), for halos of
        8, 16, 32 and 48 rows: the max and mean |Δdisparity| against the untiled
        pipeline on the interior rows (8 from each edge), and the tiled
        map's EPE and bad-2 against the ground truth. The bilateral
        position kernel couples about σp·diag pixels, so this shows which
        halo keeps the overlap-and-discard truncation under the quality
        gates.

  time  a 994×1482 synthetic pair at 64 labels (96×128 at 16 with
        `--small`) untiled and through the tiled wrapper on a one-rank
        (1, 1) world (gloo on the CPU, NCCL on the GPU): the per-device
        overhead of the wrapper; the one-tile maps' |Δdisparity| against
        the untiled one (in deterministic mode) at halo 0 (none: the same
        pipeline) and at `--halo` (the zero rows it pads the frame's edges
        with move it), beside that of two untiled runs in the default mode;
        and the one-tile map at `--halo` against the same call on the CPU,
        beside what scaling the left image by 1 + ε (one float32 rounding)
        does to the CPU's map.

    python -m depth_estimation_torch.tools.tiled_stereo_study --mode halo|time
        [--device cpu] [--halo 16] [--out result.json]

Prints one JSON line; writes it to `--out` only where given.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..crf.guides import stack_guide
from ..data.datasets import TsukubaPair
from ..data.synthetic import make_stereo_pair
from ..models.pipeline import CRFStereoConfig, calibrate_capacity, crf_stereo_infer
from ..ops.permutohedral import suggest_capacity
from ..parallel.mesh import distributed_init, make_mesh
from ..parallel.stereo_tiled import crf_stereo_infer_tiled
from ..parallel.tiling import gather_rows
from ..train.metrics import bad_pixel_ratio, epe
from ..utils.device import resolve_device
from ..utils.timing import jitter, loop_timer, scalarize

__all__ = ["run_halo", "run_time", "main"]

HALOS = (8, 16, 32, 48)  # the halo study's sweep
INTERIOR = slice(8, -8)  # rows compared in the halo study


def _halo_rank(rank: int, tiles: int, halos: tuple[int, ...], left: np.ndarray,
               right: np.ndarray, cfg: CRFStereoConfig, device: str, init_method: str,
               out_path: str) -> None:
    """One rank of the halo study's world: its stripe of the pair through
    the tiled pipeline at every halo; rank 0 saves the gathered maps."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(2)
    distributed_init("gloo", init_method=init_method, world_size=tiles, rank=rank)
    try:
        mesh = make_mesh(data=1, tile=tiles)
        lh = left.shape[0] // tiles
        rows = slice(rank * lh, (rank + 1) * lh)
        maps = {}
        for halo in halos:
            disp = crf_stereo_infer_tiled(left[rows], right[rows], cfg, mesh, halo=halo,
                                          device=device)
            maps[halo] = gather_rows(disp, mesh).cpu()
        if rank == 0:
            torch.save(maps, out_path)
    finally:
        dist.destroy_process_group()


def run_halo(args, device: torch.device) -> dict:
    """The halo sweep (`HALOS`) on the Tsukuba pair over `args.tiles` row
    stripes."""
    tsu = TsukubaPair()
    if not tsu.available():
        raise FileNotFoundError("the halo study needs the Tsukuba pair (imL.png, imR.png, "
                                "truedisp.row3.col3.pgm) in the directory DET_TSUKUBA_DIR names")
    item = tsu.load()
    left = np.asarray(item["left"], np.float32)
    right = np.asarray(item["right"], np.float32)
    if left.shape[0] % args.tiles:
        raise ValueError(f"{left.shape[0]} rows do not divide into {args.tiles} stripes")
    gt = torch.as_tensor(item["disparity"], dtype=torch.float32, device=device)
    mask = (gt > 0).float()
    cfg = calibrate_capacity(left, CRFStereoConfig(num_disp=16, niters=5, backend="lattice"),
                             headroom=3.0, tiled=False, device=device)
    untiled = crf_stereo_infer(left, right, cfg, device=device)["disparity"]
    res = {"config": "tiled_stereo_flagship_halo", "tiles": args.tiles,
           "untiled_epe": float(epe(untiled, gt, mask)),
           "untiled_bad2": float(bad_pixel_ratio(untiled, gt, 2.0, mask)), "halos": {}}
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "maps.pt")
        torch.multiprocessing.spawn(
            _halo_rank, args=(args.tiles, HALOS, left, right, cfg, str(device),
                              f"file://{tmp}/rendezvous", out_path),
            nprocs=args.tiles)
        maps = torch.load(out_path)
    for halo in HALOS:
        t = maps[halo].to(device)
        diff = (t[INTERIOR] - untiled[INTERIOR]).abs()
        res["halos"][halo] = {
            "max_abs_disp_delta": float(diff.max()),
            "mean_abs_disp_delta": float(diff.mean()),
            "epe": float(epe(t, gt, mask)),
            "bad2": float(bad_pixel_ratio(t, gt, 2.0, mask)),
        }
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_time(args, device: torch.device) -> dict:
    """Untiled against one-rank tiled on the middlebury64-size frame."""
    h, w, L = (96, 128, 16) if args.small else (994, 1482, 64)
    left, right, _ = make_stereo_pair(np.random.RandomState(0), h, w, num_layers=6,
                                      max_disp=L - 2)
    left = torch.as_tensor(left, dtype=torch.float32, device=device)
    right = torch.as_tensor(right, dtype=torch.float32, device=device)
    cfg0 = CRFStereoConfig(num_disp=L, niters=5, backend="lattice")
    ref = stack_guide(left, cfg0.sigma_color, cfg0.sigma_pos).reshape(h * w, -1)
    cfg = replace(cfg0, max_vertices=suggest_capacity(ref, headroom=3.0))
    backend = "nccl" if device.type == "cuda" else "gloo"
    distributed_init(backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                     rank=0)
    try:
        mesh = make_mesh(data=1, tile=1)
        repeat = [crf_stereo_infer(left, right, cfg, device=device)["disparity"]
                  for _ in range(2)]
        # the maps compared in deterministic mode: on the GPU `index_add_`
        # adds in no fixed order, and two runs differ (`repeat`)
        was, warn_only = (torch.are_deterministic_algorithms_enabled(),
                          torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            untiled = crf_stereo_infer(left, right, cfg, device=device)["disparity"]
            tiled = {halo: crf_stereo_infer_tiled(left, right, cfg, mesh, halo=halo,
                                                  device=device)
                     for halo in (0, args.halo)}
            # the same call on the CPU (one rank exchanges no rows), and
            # with the left image one float32 rounding off: how far one
            # rounding of the input moves the map
            on_cpu, on_cpu_ulp = (
                crf_stereo_infer_tiled(x, right.cpu(), cfg, mesh, halo=args.halo, device="cpu")
                for x in (left.cpu(), left.cpu() * (1 + torch.finfo(torch.float32).eps)))
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn_only)

        def t_untiled(a):
            return a + scalarize(crf_stereo_infer(jitter(left, a), right, cfg,
                                                  device=device)["disparity"])

        def t_tiled(a):
            return a + scalarize(crf_stereo_infer_tiled(jitter(left, a), right, cfg, mesh,
                                                        halo=args.halo, device=device))

        dt_u = loop_timer(t_untiled, reps=args.reps, device=device)
        dt_t = loop_timer(t_tiled, reps=args.reps, device=device)
    finally:
        dist.destroy_process_group()
    # A halo of 0 leaves the one stripe as the frame, so the tiled map is
    # the untiled one. Any other halo pads the frame's outer edges with zero
    # rows (as between stripes, the wrapper discards them after the CRF):
    # the dense CRF couples those black, flat-cost pixels to every row, so
    # the whole map moves, most near the edges.
    diff = (tiled[args.halo] - untiled).abs()
    cpu_diff = (tiled[args.halo].cpu() - on_cpu).abs()
    ulp_diff = (on_cpu_ulp - on_cpu).abs()
    return {"config": "tiled_stereo_middlebury", "halo": args.halo,
            "untiled_ms": dt_u * 1e3, "tiled_1chip_ms": dt_t * 1e3,
            "overhead_pct": 100.0 * (dt_t / dt_u - 1.0),
            "unit": f"ms ({h}x{w}, L={L}, one-rank 'tile' mesh)",
            "device": str(device), "backend": backend,
            "untiled_repeat_max_abs_disp_delta": float((repeat[1] - repeat[0]).abs().max()),
            "one_tile_halo0_max_abs_disp_delta": float((tiled[0] - untiled).abs().max()),
            "one_tile_max_abs_disp_delta": float(diff.max()),
            "one_tile_mean_abs_disp_delta": float(diff.mean()),
            "one_tile_rows_over_5e-3px": int((diff.amax(dim=1) > 5e-3).sum()),
            "one_tile_cpu_max_abs_disp_delta": float(cpu_diff.max()),
            "one_tile_cpu_mean_abs_disp_delta": float(cpu_diff.mean()),
            "cpu_one_ulp_max_abs_disp_delta": float(ulp_diff.max()),
            "cpu_one_ulp_mean_abs_disp_delta": float(ulp_diff.mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("halo", "time"), required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--tiles", type=int, default=4)
    ap.add_argument("--halo", type=int, default=16, help="halo of --mode time")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = run_halo(args, dev) if args.mode == "halo" else run_time(args, dev)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
