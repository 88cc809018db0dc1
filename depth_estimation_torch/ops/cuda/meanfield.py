"""Fused mean-field update: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas kernel `fused_energy_update`
(the JAX package's `ops/pallas/meanfield.py`). One iteration of the
dense CRF's mean field, given the unaries E0, the filtered message
S = W·C and the compatibility-transformed beliefs C = Q·Mu:

    E  = E0 + (S − C),   Q' = softmax(−E),   C' = Q'·Mu

The kernel (`csrc/meanfield.cu`) gives each warp one tile of consecutive
rows, loaded by coalesced 16-byte words; its source note gives the memory
bound. `launch_geometry` computes the tiles, the grid and the shared memory
here, where the CPU tests reach it. A CUDA tensor goes to the kernel or
raises; a CPU tensor goes to `fused_energy_update_reference`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

__all__ = ["fused_energy_update", "fused_energy_update_reference", "launch_geometry",
           "Geometry", "SUPPORTED_L"]

SUPPORTED_L = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launch geometry (must agree with csrc/meanfield.cu)
WARPS = 4  # warps in a block: 128 threads, __launch_bounds__(128, 4)
TILE_WORDS = 128  # 16-byte words of each array in a warp tile: 4 a lane


@dataclass(frozen=True)
class Geometry:
    """A launch of the kernel: `num_tiles` warp tiles of `tile_rows` rows
    (the last one ragged), one a warp, in `grid` blocks of WARPS warps;
    warp w of the grid computes rows [w·tile_rows, (w + 1)·tile_rows) that
    are < n. The warps hold their q scratch in `smem_bytes` of shared
    memory."""

    tile_rows: int
    num_tiles: int
    grid: int
    smem_bytes: int


def launch_geometry(n: int, L: int, elt: int) -> Geometry:
    """The kernel's geometry for (n, L) rows of `elt`-byte values: tiles of
    TILE_WORDS words of each array, as many as n needs."""
    if n < 1:
        raise ValueError(f"n={n}: the kernel needs at least one row")
    tile_rows = TILE_WORDS * 16 // (L * elt)
    num_tiles = -(-n // tile_rows)
    grid = -(-num_tiles // WARPS)
    smem = WARPS * tile_rows * (L + 4) * 4  # q in f32, rows padded by 4 floats
    return Geometry(tile_rows, num_tiles, grid, smem)


def fused_energy_update_reference(E0, S, C, Mu):
    """Plain PyTorch version of the kernel: computes in f32 and rounds each
    output once to the I/O dtype. Returns (E, C')."""
    dt = E0.dtype
    E = E0.float() + (S.float() - C.float())
    Q = torch.softmax(-E, dim=-1)
    return E.to(dt), (Q @ Mu.float()).to(dt)


def _lib():
    from ...utils.build import load_library

    fn = load_library("meanfield").fused_energy_update_launch
    # without argtypes ctypes would pass each pointer as a 32-bit int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_energy_update(E0: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
                        Mu: torch.Tensor):
    """(E, C') from (n, L) E0, S, C and (L, L) Mu, all of one dtype
    (float32 or bfloat16) and on one device."""
    if E0.device.type == "cpu":
        return fused_energy_update_reference(E0, S, C, Mu)
    if E0.device.type != "cuda":
        raise ValueError(f"unsupported device {E0.device}")
    n, L = E0.shape
    if L not in SUPPORTED_L:
        raise ValueError(f"L={L} not in {SUPPORTED_L}")
    if E0.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {E0.dtype}")
    for name, x, shape in (("S", S, (n, L)), ("C", C, (n, L)), ("Mu", Mu, (L, L))):
        if x.device != E0.device or x.dtype != E0.dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {shape} {E0.dtype} on {E0.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    for name, x in (("E0", E0), ("S", S), ("C", C), ("Mu", Mu)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    E = torch.empty_like(E0)
    Cn = torch.empty_like(E0)
    if n == 0:
        return E, Cn
    with torch.cuda.device(E0.device):
        g = launch_geometry(n, L, E0.element_size())
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(E0.data_ptr(), S.data_ptr(), C.data_ptr(), Mu.data_ptr(),
                     E.data_ptr(), Cn.data_ptr(), n, L, _DTYPES[E0.dtype], g.tile_rows,
                     g.num_tiles, g.grid, g.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fused_energy_update launch failed: cudaError {err}")
    fused_energy_update.launches += 1
    return E, Cn


fused_energy_update.launches = 0  # kernel launches, for run-time path checks
