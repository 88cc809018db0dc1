"""Build and load the package's CUDA sources (`csrc/*.cu`).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). Libraries go to `depth_estimation_torch/_build/` (listed in
`.gitignore`), named by a hash of the source, of every header under
`csrc/` and of the flags, so an edited source or header rebuilds and an
unchanged one is reused. Beside each library is the compiler's log, with
`ptxas`'s registers, shared memory and spills of every kernel
(`build_log`). Nothing is built when the module is imported: `load_library`
builds at first use, and `build_all` starts one `nvcc` per source, all at
once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "build_log", "load_library"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str) -> Path:
    """The library of csrc/<name>.cu, keyed by the source, every header it
    can include (csrc/**/*.cuh, *.h) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    headers = sorted(p for p in CSRC.rglob("*") if p.suffix in (".cuh", ".h") and p.is_file())
    for p in headers:
        h.update(str(p.relative_to(CSRC)).encode() + b"\0" + p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling csrc/<name>.cu unless its library exists; returns
    (target, process or None, temporary output)."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu in parallel; returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {name: _start(name) for name in names}
    return {name: _finish(name, *started[name]) for name in names}


def build_log(name: str) -> str:
    """nvcc's output for the current library of csrc/<name>.cu (built first
    if needed), `ptxas info` lines included."""
    return _finish(name, *_start(name)).with_suffix(".log").read_text()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(_finish(name, *_start(name))))
    return _loaded[name]
