"""ctypes binding to the repository's C++ CPU lattice (`native/lattice_cpu.cpp`).

The host-side counterpart of `ops.permutohedral`: the same filter
conventions in an independent implementation (C++, sort-based dedup), for
preprocessing off the card and as an oracle in tests. Its C interface is
the JAX package's binding's. The library is built at first use by
`utils.build` (g++ with `native/Makefile`'s flags, into the package's
git-ignored `_build/`); the source is only read.

API (numpy in, numpy out, float32):
  lattice_filter_cpu(src, ref, normalize='none') -> (n, L) array
  LatticePlanCPU(ref): a plan built once per reference, `.apply(src)` many times
"""
from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["lattice_filter_cpu", "LatticePlanCPU"]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from .build import load_library

    lib = load_library("lattice_cpu")
    # explicit argtypes: every pointer passes as 64 bits
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.det_lattice_filter_f32.argtypes = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int]
    lib.det_lattice_filter_f32.restype = ctypes.c_int
    lib.det_lattice_plan_build.argtypes = [f32p, ctypes.c_int64, ctypes.c_int]
    lib.det_lattice_plan_build.restype = ctypes.c_void_p
    lib.det_lattice_plan_apply.argtypes = [ctypes.c_void_p, f32p, f32p, ctypes.c_int,
                                           ctypes.c_int]
    lib.det_lattice_plan_apply.restype = ctypes.c_int
    lib.det_lattice_plan_vertices.argtypes = [ctypes.c_void_p]
    lib.det_lattice_plan_vertices.restype = ctypes.c_int64
    lib.det_lattice_plan_free.argtypes = [ctypes.c_void_p]
    lib.det_lattice_plan_free.restype = None
    _lib = lib
    return lib


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _mode(normalize: str) -> int:
    if normalize not in ("none", "homogeneous"):
        raise ValueError(f"unknown normalize {normalize!r}")
    return int(normalize == "homogeneous")


def lattice_filter_cpu(src, ref, normalize: str = "none") -> np.ndarray:
    """One-shot filter: (n, L) values over (n, d) positions → (n, L) float32."""
    lib = _load()
    src, ref = _as_f32(src), _as_f32(ref)
    n, L = src.shape
    if ref.ndim != 2 or ref.shape[0] != n:
        raise ValueError(f"ref: want ({n}, d), got {ref.shape}")
    out = np.empty((n, L), np.float32)
    rc = lib.det_lattice_filter_f32(_ptr(src), _ptr(ref), _ptr(out), n, L, ref.shape[1],
                                    _mode(normalize))
    if rc != 0:
        raise RuntimeError(f"native lattice filter failed (rc={rc})")
    return out


class LatticePlanCPU:
    """A reusable plan: built once for the (n, d) positions `ref`, applied
    to any (n, L) values."""

    def __init__(self, ref):
        lib = _load()
        ref = _as_f32(ref)
        self._lib = lib
        self._n, self._d = ref.shape
        self._handle = lib.det_lattice_plan_build(_ptr(ref), self._n, self._d)
        if not self._handle:
            raise RuntimeError("native plan build failed")

    @property
    def num_vertices(self) -> int:
        return int(self._lib.det_lattice_plan_vertices(self._handle))

    def apply(self, src, normalize: str = "none") -> np.ndarray:
        src = _as_f32(src)
        n, L = src.shape
        if n != self._n:
            raise ValueError(f"src: want {self._n} rows, got {n}")
        out = np.empty((n, L), np.float32)
        rc = self._lib.det_lattice_plan_apply(self._handle, _ptr(src), _ptr(out), L,
                                              _mode(normalize))
        if rc != 0:
            raise RuntimeError(f"native plan apply failed (rc={rc})")
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.det_lattice_plan_free(self._handle)
            self._handle = None
