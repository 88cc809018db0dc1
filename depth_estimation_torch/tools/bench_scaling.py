"""Frames/s of the batched lattice pipeline against the world size
(counterpart of the JAX system's `tools/bench_scaling.py`).

For each world size c of the sweep, c ranks join one `torch.distributed`
world through `parallel.mesh.distributed_init` (NCCL with one card a rank
on the GPU, gloo on the CPU), form a (c, 1) mesh and serve a batch of
`--frames-per-device`·c frames through `StereoServer(mesh=...)`: each rank
runs its rows of the batch and the disparities are gathered on every rank.
The configuration is the JAX tool's: the lattice backend at the capacity
`1 << max(10, (2hw − 1).bit_length())`. The frames are uniform noise from
`RandomState(0)`, the same on every rank. Each rank serves one batch to warm
up, then `--reps` batches between two barriers; the slowest rank's time a
batch gives frames/s, and `efficiency_vs_linear` is frames/s over c times
the smallest size's frames/s a rank. A world of one rank runs in this
process, a larger one in spawned processes.

On the GPU the sweep is capped at the cards present: ranks that share one
card do not scale, and are never reported as scaling. On one card the sweep
is size 1, and `note` says so. On the CPU the ranks share the host's cores,
so the sweep checks the harness (every size joins, serves its rows and
gathers), not scaling; `note` says so.

    python -m depth_estimation_torch.tools.bench_scaling [--device cpu]
        [--devices 1 2 4] [--frames-per-device 2] [--h 72 --w 96]
        [--labels 8] [--niters 5] [--reps 5] [--out FILE]

Prints one JSON line; writes it to `--out` only where given.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.pipeline import CRFStereoConfig
from ..models.serving import StereoServer
from ..parallel.mesh import distributed_init, make_mesh
from ..utils.device import resolve_device
from .bench_suite import device_name

__all__ = ["SIZES", "parse_args", "scaling_cfg", "run_world", "main"]

SIZES = (1, 2, 4, 8, 16, 32)  # the default sweep, up to the devices present


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device type (default: the GPU)")
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="world sizes to sweep (default: 1, 2, 4, ... up to the devices present)")
    ap.add_argument("--frames-per-device", type=int, default=2)
    ap.add_argument("--h", type=int, default=72)
    ap.add_argument("--w", type=int, default=96)
    ap.add_argument("--labels", type=int, default=8)
    ap.add_argument("--niters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    return ap.parse_args(argv)


def scaling_cfg(h: int, w: int, labels: int, niters: int) -> CRFStereoConfig:
    """The JAX tool's configuration: the lattice at pow2 ≥ 2hw vertices
    (at least 1024)."""
    return CRFStereoConfig(num_disp=labels, niters=niters, backend="lattice",
                           max_vertices=1 << max(10, (2 * h * w - 1).bit_length()))


def _rank(rank: int, size: int, args: argparse.Namespace, device_type: str, init_method: str,
          out_path: str | None) -> tuple[float, torch.Tensor]:
    """One rank of a world of `size`: serve the batch, time `args.reps`
    batches between barriers; returns (the slowest rank's seconds a batch,
    the gathered disparities), and rank 0 saves them to `out_path`."""
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        if size > 1:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    distributed_init("nccl" if device_type == "cuda" else "gloo", init_method=init_method,
                     world_size=size, rank=rank)
    try:
        rng = np.random.RandomState(0)
        shape = (args.frames_per_device * size, args.h, args.w, 3)
        left, right = (torch.as_tensor(rng.rand(*shape), dtype=torch.float32, device=dev)
                       for _ in range(2))
        server = StereoServer(scaling_cfg(args.h, args.w, args.labels, args.niters),
                              mesh=make_mesh(data=size), auto_capacity=False, device=dev)
        out = server(left, right)  # warm-up
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = server(left, right)
        _sync(dev)
        dist.barrier()
        seconds = torch.tensor([(time.perf_counter() - t0) / args.reps], dtype=torch.float64,
                               device=dev)
        dist.all_reduce(seconds, op=dist.ReduceOp.MAX)
        res = float(seconds), out.cpu()
        if rank == 0 and out_path is not None:
            torch.save(res, out_path)
        return res
    finally:
        dist.destroy_process_group()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_world(size: int, args: argparse.Namespace, device_type: str) -> tuple[float, torch.Tensor]:
    """(seconds a batch, the (frames, h, w) disparities) of a world of
    `size` ranks: this process alone for 1, spawned ranks above."""
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        if size == 1:
            return _rank(0, 1, args, device_type, init, None)
        out_path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(_rank, args=(size, args, device_type, init, out_path),
                                    nprocs=size)
        return torch.load(out_path)


def main(argv=None) -> dict:
    """Sweep `argv`'s world sizes; print and return the JSON line."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    present = torch.cuda.device_count() if dev.type == "cuda" else (os.cpu_count() or 1)
    wanted = args.devices or list(SIZES)
    sizes = [c for c in wanted if c <= present]
    if not sizes:
        raise ValueError(f"no world size of {wanted} fits the {present} devices present")
    per = {}
    for c in sizes:
        seconds, _ = run_world(c, args, dev.type)
        per[str(c)] = round(args.frames_per_device * c / seconds, 3)
    base = per[str(sizes[0])] / sizes[0]
    eff = {str(c): round(per[str(c)] / (base * c), 4) for c in sizes}
    if dev.type == "cpu":
        note = (f"the ranks share {present} host cores: the sweep checks the harness (every "
                "world size joins, serves its rows and gathers), not hardware scaling; "
                "efficiency is bound by the core count")
    elif present == 1:
        note = ("one card: the sweep is size 1 and measures no scaling (ranks sharing one "
                "card do not scale, and are not run)")
    elif len(sizes) < len(wanted):
        note = (f"{present} cards: world sizes above {present} are not run (ranks sharing "
                "one card do not scale)")
    else:
        note = None
    result = {
        "metric": "scaling_frames_per_s",
        "unit": f"frames/s ({args.h}x{args.w}px, L={args.labels}, lattice CRF, "
                f"{args.frames_per_device}/device)",
        "device": device_name(dev),
        "frames_per_s": per,
        "efficiency_vs_linear": eff,
        "note": note,
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
