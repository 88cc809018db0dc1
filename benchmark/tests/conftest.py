"""Fixtures of the benchmark's tests: small copies of the cells for the CPU
(BENCHMARK.json's, and the serving cell its pieces make, which
BENCHMARK.json leaves out), and `card`, which skips a test marked `cuda`
where there is no GPU."""
from __future__ import annotations

import copy

import pytest
import torch

from benchmark.harness import cell_of, load_spec, make_cell

# sizes a CPU test run holds: per cell, configuration and traffic overrides
SMALL = {
    "fullres128.stream": ({"height": 96, "width": 128, "num_disp": 24},
                          {"max_disp": 16, "pool": 4, "check_frames": 2}),
    "wide320.stream": ({"height": 96, "width": 128, "num_disp": 40},
                       {"max_disp": 38, "pool": 4, "check_frames": 2}),
    "middlebury64.stream": ({"height": 96, "width": 128, "num_disp": 16},
                            {"max_disp": 14, "pool": 4, "check_frames": 2}),
    "tsukuba16.serve": ({"height": 64, "width": 96},
                        {"pool": 16, "batch": 4, "max_disp": 8, "num_layers": 3,
                         "check_frames": 4, "trace_units": 2}),
    "tsukuba16.train": ({"height": 64, "width": 96},
                        {"pool": 8, "max_disp": 8, "num_layers": 3, "trace_units": 2}),
}


def full_cell(name: str):
    """The cell of BENCHMARK.json, or one made of its files by the name
    <config>.<traffic>."""
    if name in {w["name"] for w in load_spec()["workloads"]}:
        return cell_of(load_spec(), name)
    return make_cell(name, *name.split("."))


def small_cell(name: str):
    cell = copy.deepcopy(full_cell(name))
    config, traffic = SMALL[name]
    cell.config.update(config)
    cell.traffic.update(traffic)
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
