"""Run one cell of the benchmark once, on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. Set-up (the pool made on the card from the
seed, the program's object built and calibrated, its kernels built into
the program's own `_build/` on a checkout's first run) and a warm-up,
then `--seconds` of closed-loop requests; with `--trace 1` also a
profiled slice and a slice that counts the host's waits, after the
window. Then the program's state is freed and its answers are compared
with the plain reference. The last line of standard output is the
result; the numbers compared and their limits are the last lines of
standard error. Without a card, or with fewer cards than the cell asks
for, it prints no result and exits with 2; where a module of JAX or of
the JAX package is loaded once the window has closed, with 3.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a library could fill goes to one fixed place in the checkout
CACHE = ROOT / ".benchmark_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

import torch  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from .harness import cell_of, forbidden_modules, load_spec, run_cell

    cell = cell_of(load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # the host's part is one Python thread's dispatch
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}) {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_strict(result)), flush=True)
    return 0


def _strict(x):
    """x with every non-finite float as null, so that the line is JSON."""
    if isinstance(x, dict):
        return {k: _strict(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_strict(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


if __name__ == "__main__":
    sys.exit(main())
