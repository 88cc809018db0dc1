"""The readings that the limits of `correct` are set from, for one cell on
many seeds in one process:

    python3 -m benchmark.control --workload <name> --seeds <n> ... \
        [--control-seeds K] [--seconds S] [--fault NAME]

For each seed: the cell's set-up, warm-up and `--seconds` of its window
(enough to answer every pair the comparison samples), the program's state
freed, then the numbers the comparison computes (the lower readings). For
the first K seeds also the control's numbers: the plain reference at the
next precision below the configuration's, put in the program's place (the
upper readings). With `--fault`, the program runs with that fault planted
(`benchmark.faults`) and only its numbers are read. One JSON line a seed
on standard output, then a line of the largest program reading and the
smallest control reading of each number.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import faults
from .harness import cell_of, entry_module, load_spec, run_units


def readings(cell, seed: int, seconds: float, control: bool, device, fault: str | None = None):
    """The program's numbers (and the control's) for one seed."""
    mod = entry_module(cell)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        entry = mod.Entry(cell.config, cell.traffic, seed, device)
        entry.warm()
        _, _, _, units, failed = run_units(entry, entry.next_unit, 0, seconds)
        failed += entry.failed()
        entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out = {"seed": seed, "units": units, "failed": failed, "program": entry.check()}
    out["check_s"] = time.perf_counter() - t
    out["program_detail"] = getattr(entry, "detail", None)
    if control:
        t = time.perf_counter()
        out["control"] = entry.control()
        out["control_s"] = time.perf_counter() - t
        out["control_detail"] = getattr(entry, "detail", None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault", choices=sorted({f for v in faults.FAULTS.values() for f in v}))
    args = p.parse_args(argv)
    device = torch.device("cuda")
    cell = cell_of(load_spec(), args.workload)
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        row = readings(cell, seed, args.seconds, i < args.control_seeds and not args.fault,
                       device, args.fault)
        row.update(workload=cell.name, fault=args.fault, seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell.name, "fault": args.fault,
               "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    if "control" in rows[0]:
        summary["control_min"] = {k: min(r["control"][k] for r in rows if "control" in r)
                                  for k in rows[0]["control"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
