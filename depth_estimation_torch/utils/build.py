"""Build and load the package's native sources: the CUDA kernels
(`csrc/*.cu`) and the repository's C++ CPU lattice (`native/lattice_cpu.cpp`).

Each CUDA source is compiled by `nvcc` for sm_90a into a shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds). The CPU lattice (`HOST_SOURCES`) is compiled by `g++`
with the flags of `native/Makefile`, read where it lies and never written
to. Libraries go to `depth_estimation_torch/_build/` (listed in
`.gitignore`), named by a hash of the source, of the flags and, for a CUDA
source, of every header under `csrc/`, for the CPU lattice of the host's
CPU (`-march=native`), so an edited source or header rebuilds and an
unchanged one is reused. Beside each library is the compiler's log, with
`ptxas`'s registers, shared memory and spills of every kernel
(`build_log`). Nothing is built when the module is imported: `load_library`
builds at first use, and `build_all` starts one compiler per source, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "GXX_FLAGS", "HOST_SOURCES", "build_all",
           "build_log", "load_library"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# C++ sources for the host, by library name: native/Makefile's flags
HOST_SOURCES = {"lattice_cpu": PKG.parent / "native" / "lattice_cpu.cpp"}
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found")
    return found


def _host_cpu() -> bytes:
    """What `-march=native` compiles for: the CPU's model and flags."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(dict.fromkeys(keep)).encode()


def _source(name: str) -> Path:
    return HOST_SOURCES.get(name) or CSRC / f"{name}.cu"


def _target(name: str) -> Path:
    """The library of csrc/<name>.cu, keyed by the source, every header it
    can include (csrc/**/*.cuh, *.h) and the flags; or of a host source,
    keyed by the source, the flags and the host's CPU."""
    h = hashlib.sha256(_source(name).read_bytes())
    if name in HOST_SOURCES:
        h.update(" ".join(GXX_FLAGS).encode() + b"\0" + _host_cpu())
        return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    headers = sorted(p for p in CSRC.rglob("*") if p.suffix in (".cuh", ".h") and p.is_file())
    for p in headers:
        h.update(str(p.relative_to(CSRC)).encode() + b"\0" + p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling csrc/<name>.cu (or a host source) unless its library
    exists; returns (target, process or None, temporary output)."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compiler = [_gxx(), *GXX_FLAGS] if name in HOST_SOURCES else [_nvcc(), *NVCC_FLAGS]
    cmd = [*compiler, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(proc.args[0]).name} failed for {_source(name).name}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu and every host source in parallel; returns
    {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) + sorted(HOST_SOURCES)
    started = {name: _start(name) for name in names}
    return {name: _finish(name, *started[name]) for name in names}


def build_log(name: str) -> str:
    """The compiler's output for the current library of csrc/<name>.cu or
    a host source (built first if needed), `ptxas info` lines included."""
    return _finish(name, *_start(name)).with_suffix(".log").read_text()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu or a host source, built first
    if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(_finish(name, *_start(name))))
    return _loaded[name]
