"""The command as the driver runs it: no result without a card, none in a
checkout that holds only the benchmark, and no JAX loaded by a cell."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import ROOT, load_spec

CMD = load_spec()["command"]


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable if c == "python3" else c for c in CMD] + list(args),
                          cwd=cwd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, **(env or {})})


def test_no_result_without_a_card():
    out = _run(ROOT, "--workload", "tsukuba16.train", "--seed", str(2**31 + 5), "--seconds",
               "1", "--trace", "0", env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in load_spec()["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "fullres128.stream", "--seed", "3", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["tsukuba16.serve", "tsukuba16.train", "fullres128.stream"])
def test_a_cell_loads_no_jax(name):
    """A cell's set-up and a short window, at a small size on the CPU, in a
    process of its own: no module of JAX or of the JAX package is loaded."""
    code = f"""
import json, sys, time
from benchmark.tests.conftest import small_cell
from benchmark.harness import forbidden_modules, run_cell
res = run_cell(small_cell({name!r}), 2**31 + 77, 0.5, False, "cpu", time.perf_counter())
print(json.dumps({{"forbidden": forbidden_modules(),
                  "port": "depth_estimation_torch" in sys.modules, "keys": list(res)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [] and got["port"]
    assert got["keys"] == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_the_harness_imports_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib", "flax",
                                                            "depth_estimation_tpu"}, path
