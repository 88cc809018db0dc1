"""The port's binding to the C++ CPU lattice (`utils/native.py`) against the
JAX package's binding to the same source, and against the port's own
`lattice_filter`, as tests/test_native.py holds the JAX one.

The JAX binding builds with `make -C` in its source directory; here it is
pointed at a copy of `native/` under tmp_path, so that no test writes into
the repository's `native/` while another process may load from it."""
import ast
import importlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from depth_estimation_torch.ops.permutohedral import lattice_filter
from depth_estimation_torch.utils import build
from depth_estimation_torch.utils.native import LatticePlanCPU, lattice_filter_cpu

PKG = build.PKG
REPO = PKG.parent
JN = importlib.import_module("depth_estimation_tpu.utils.native")


@pytest.fixture(scope="module")
def jax_binding(tmp_path_factory):
    """The JAX package's binding, built by its own `make` in a copy of
    native/ (sources only)."""
    native = tmp_path_factory.mktemp("jax_native")
    for name in ("Makefile", "lattice_cpu.cpp"):
        shutil.copy(REPO / "native" / name, native / name)
    mp = pytest.MonkeyPatch()
    mp.setattr(JN, "_NATIVE_DIR", native)
    mp.setattr(JN, "_LIB_PATH", native / "liblattice_cpu.so")
    mp.setattr(JN, "_lib", None)
    yield JN
    mp.undo()


@pytest.mark.parametrize("d", [1, 2, 5])
def test_native_matches_jax_binding(jax_binding, d):
    n, L = 200, 3
    rs = np.random.RandomState(d)
    ref = rs.randn(n, d).astype(np.float32) * 1.5
    src = rs.rand(n, L).astype(np.float32)
    got = lattice_filter_cpu(src, ref)
    want = jax_binding.lattice_filter_cpu(src, ref)
    assert got.dtype == np.float32 and got.shape == (n, L)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_native_homogeneous_and_plan_match_jax_binding(jax_binding):
    rs = np.random.RandomState(7)
    ref = rs.randn(150, 3).astype(np.float32)
    src = rs.rand(150, 2).astype(np.float32)
    np.testing.assert_allclose(lattice_filter_cpu(src, ref, normalize="homogeneous"),
                               jax_binding.lattice_filter_cpu(src, ref, normalize="homogeneous"),
                               rtol=1e-6, atol=0)
    ours, theirs = LatticePlanCPU(ref), jax_binding.LatticePlanCPU(ref)
    assert ours.num_vertices == theirs.num_vertices > 0
    for L in (1, 4):
        x = rs.rand(150, L).astype(np.float32)
        np.testing.assert_allclose(ours.apply(x), theirs.apply(x), rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [1, 2, 5])
def test_native_matches_port_lattice(d):
    n, L = 200, 3
    rs = np.random.RandomState(10 + d)
    ref = rs.randn(n, d).astype(np.float32) * 1.5
    src = rs.rand(n, L).astype(np.float32)
    want = lattice_filter(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(lattice_filter_cpu(src, ref), want, rtol=2e-4, atol=2e-4)


def test_native_homogeneous_matches_port_lattice():
    rs = np.random.RandomState(20)
    ref = rs.randn(150, 3).astype(np.float32)
    src = rs.rand(150, 2).astype(np.float32)
    want = lattice_filter(torch.from_numpy(src), torch.from_numpy(ref),
                          normalize="homogeneous").numpy()
    np.testing.assert_allclose(lattice_filter_cpu(src, ref, normalize="homogeneous"), want,
                               rtol=5e-4, atol=5e-4)


def test_native_plan_reuse():
    rs = np.random.RandomState(21)
    ref = rs.randn(100, 2).astype(np.float32)
    plan = LatticePlanCPU(ref)
    assert plan.num_vertices > 0
    a, b = plan.apply(rs.rand(100, 2)), plan.apply(rs.rand(100, 4))
    assert a.shape == (100, 2) and b.shape == (100, 4)
    ones = np.ones((100, 1), np.float32)
    np.testing.assert_allclose(plan.apply(ones), lattice_filter_cpu(ones, ref), rtol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        plan.apply(np.ones((99, 1), np.float32))
    with pytest.raises(ValueError, match="normalize"):
        lattice_filter_cpu(ones, ref, normalize="l1")


def test_port_build_never_writes_beside_its_source(tmp_path):
    """Alone in a fresh process, before anything imports the JAX binding,
    the port compiles the CPU lattice with g++ into its build directory:
    no `make`, and no file added to or changed in the source's directory
    (a copy of native/ here; the real one is the default source)."""
    assert build._source("lattice_cpu") == REPO / "native" / "lattice_cpu.cpp"
    assert build._target("lattice_cpu").parent == build.BUILD_DIR == PKG / "_build"
    assert "depth_estimation_torch/_build/" in (REPO / ".gitignore").read_text().splitlines()
    native = tmp_path / "native"
    shutil.copytree(REPO / "native", native, ignore=shutil.ignore_patterns("*.so"))
    before = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in native.iterdir()}
    code = f"""
import subprocess, sys
from pathlib import Path
ran = []
_Popen = subprocess.Popen
class Popen(_Popen):
    def __init__(self, cmd, *a, **k):
        ran.append(list(cmd))
        super().__init__(cmd, *a, **k)
subprocess.Popen = Popen
from depth_estimation_torch.utils import build
build.HOST_SOURCES["lattice_cpu"] = Path({str(native / "lattice_cpu.cpp")!r})
build.BUILD_DIR = Path({str(tmp_path / "_build")!r})
from depth_estimation_torch.utils.native import lattice_filter_cpu
import numpy as np
out = lattice_filter_cpu(np.ones((10, 1), np.float32), np.zeros((10, 2), np.float32))
assert out.shape == (10, 1)
assert [Path(c[0]).name for c in ran] == ["g++"], ran
assert all(flag in ran[0] for flag in build.GXX_FLAGS)
assert not any(m.startswith("depth_estimation_tpu") or m == "jax" for m in sys.modules)
print(sorted(p.name for p in build.BUILD_DIR.iterdir()))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    built = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    assert len(built) == 2 and built[0].startswith("liblattice_cpu-")
    assert {b.rsplit(".", 1)[1] for b in built} == {"log", "so"}
    after = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in native.iterdir()}
    assert after == before
