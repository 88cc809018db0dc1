"""Fused mean-field update: the CUDA kernels' wrappers and their plain version.

Replaces the Pallas kernel `fused_energy_update`
(the JAX package's `ops/pallas/meanfield.py`). One iteration of the
dense CRF's mean field, given the unaries E0, the filtered message
S = W·C and the compatibility-transformed beliefs C = Q·Mu:

    E  = E0 + (S − C),   Q' = softmax(−E),   C' = Q'·Mu

Two hand-written kernels serve every label count L (`kernel_for`):

- K1 (`csrc/meanfield.cu`) for L in `SUPPORTED_L`: each warp takes one
  tile of consecutive rows, loaded by coalesced 16-byte words, with Mu in
  registers; `launch_geometry` computes its tiles, grid and shared memory.
- K1w (`csrc/meanfield_wide.cu`, `fused_energy_update_wide`) for every other
  L: a block per tile of rows, values read one by one (any row width), q in
  shared memory and Mu staged through it in blocks; `wide_geometry`
  computes its tiles and shared memory.

Both geometries are computed here, where the CPU tests reach them, and
re-checked by the C side. A CUDA tensor goes to a kernel or raises; a CPU
tensor goes to `fused_energy_update_reference`. Each wrapper counts its own
kernel's launches (`fused_energy_update.launches` for K1,
`fused_energy_update_wide.launches` for K1w).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

__all__ = ["fused_energy_update", "fused_energy_update_wide", "fused_energy_update_reference",
           "kernel_for", "launch_geometry", "wide_geometry", "Geometry", "WideGeometry",
           "SUPPORTED_L"]

SUPPORTED_L = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launch geometry (must agree with csrc/meanfield.cu)
WARPS = 4  # warps in a block: 128 threads, __launch_bounds__(128, 4)
TILE_WORDS = 128  # 16-byte words of each array in a warp tile: 4 a lane

# K1w's geometry (must agree with csrc/meanfield_wide.cu)
WIDE_THREADS = 256  # a block: __launch_bounds__(256, 2)
WIDE_ROWS_PER_THREAD = 4  # rows of C' a thread carries
WIDE_MU_ROWS = 64  # rows of Mu staged in shared memory at once
WIDE_MAX_COL_CHUNK = 64  # columns of Mu staged at once
WIDE_SMEM_TARGET = 100 * 1024  # a block's shared memory, where one q row fits
MAX_SMEM = 232448  # the H100's opt-in limit a block (227 KB)


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


def kernel_for(L: int) -> str:
    """Which kernel serves L labels on the card: 'K1' for L in
    SUPPORTED_L, 'K1w' for every other L ≥ 1."""
    if L < 1:
        raise ValueError(f"L={L}: the update needs at least one label")
    return "K1" if L in SUPPORTED_L else "K1w"


@dataclass(frozen=True)
class WideGeometry:
    """A launch of K1w: `num_tiles` blocks of WIDE_THREADS threads, block b
    computing rows [b·tile_rows, (b + 1)·tile_rows) that are < n. Its
    dynamic shared memory (`smem_bytes`) holds the tile's q in f32, rows of
    `q_stride` floats, and one block of WIDE_MU_ROWS × `col_chunk` of Mu."""

    tile_rows: int
    q_stride: int
    col_chunk: int
    num_tiles: int
    smem_bytes: int


def wide_geometry(n: int, L: int) -> WideGeometry:
    """K1w's geometry for (n, L) rows: Mu columns in chunks of the power of
    two ≥ L (4 to 64; four columns a thread), as many rows a tile as the
    threads carry (WIDE_ROWS_PER_THREAD each) while the tile's q and a Mu
    block fit WIDE_SMEM_TARGET, and at least one row. Raises where one row
    of q and a Mu block exceed the card's shared memory (L > 54,012)."""
    if n < 1:
        raise ValueError(f"n={n}: the kernel needs at least one row")
    if L < 1:
        raise ValueError(f"L={L}: the kernel needs at least one label")
    col_chunk = 4
    while col_chunk < min(L, WIDE_MAX_COL_CHUNK):
        col_chunk *= 2
    q_stride = -(-L // 4) * 4 + 4  # whole float4s, plus 4 against bank conflicts
    mu_bytes = WIDE_MU_ROWS * col_chunk * 4
    carried = WIDE_THREADS // (col_chunk // 4) * WIDE_ROWS_PER_THREAD
    fit = (WIDE_SMEM_TARGET - mu_bytes) // (q_stride * 4)
    tile_rows = max(1, min(carried, fit))
    smem = tile_rows * q_stride * 4 + mu_bytes
    if smem > MAX_SMEM:
        raise ValueError(f"L={L}: one row of q and a block of Mu need {smem} bytes of shared "
                         f"memory, over the card's {MAX_SMEM}")
    return WideGeometry(tile_rows, q_stride, col_chunk, -(-n // tile_rows), smem)


def fused_energy_update_reference(E0, S, C, Mu):
    """Plain PyTorch version of the kernel: computes in f32 and rounds each
    output once to the I/O dtype. Returns (E, C')."""
    dt = E0.dtype
    E = E0.float() + (S.float() - C.float())
    Q = torch.softmax(-E, dim=-1)
    return E.to(dt), (Q @ Mu.float()).to(dt)


def _lib(name: str, symbol: str, ints: int):
    from ...utils.build import load_library

    fn = getattr(load_library(name), symbol)
    # without argtypes ctypes would pass each pointer as a 32-bit int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _checked(E0, S, C, Mu):
    """(n, L) after checking the four arrays: one dtype (float32 or
    bfloat16), one CUDA device, the shapes (n, L) and (L, L), contiguous."""
    if E0.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {E0.dtype}")
    if E0.device.type != "cuda":
        raise ValueError(f"unsupported device {E0.device}")
    if E0.dim() != 2:
        raise ValueError(f"E0: want (n, L), got {tuple(E0.shape)}")
    n, L = E0.shape
    for name, x, shape in (("S", S, (n, L)), ("C", C, (n, L)), ("Mu", Mu, (L, L))):
        if x.device != E0.device or x.dtype != E0.dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {shape} {E0.dtype} on {E0.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    for name, x in (("E0", E0), ("S", S), ("C", C), ("Mu", Mu)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, L


def fused_energy_update(E0: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
                        Mu: torch.Tensor):
    """(E, C') from (n, L) E0, S, C and (L, L) Mu, all of one dtype
    (float32 or bfloat16) and on one device. On the card, L in SUPPORTED_L
    launches K1 and every other L launches K1w (`kernel_for`)."""
    if E0.device.type == "cpu":
        return fused_energy_update_reference(E0, S, C, Mu)
    n, L = _checked(E0, S, C, Mu)
    if kernel_for(L) == "K1w":
        return fused_energy_update_wide(E0, S, C, Mu)
    for name, x in (("E0", E0), ("S", S), ("C", C), ("Mu", Mu)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    E = torch.empty_like(E0)
    Cn = torch.empty_like(E0)
    if n == 0:
        return E, Cn
    with torch.cuda.device(E0.device):
        g = launch_geometry(n, L, E0.element_size())
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("meanfield", "fused_energy_update_launch", 6)(
            E0.data_ptr(), S.data_ptr(), C.data_ptr(), Mu.data_ptr(), E.data_ptr(),
            Cn.data_ptr(), n, L, _DTYPES[E0.dtype], g.tile_rows, g.num_tiles, g.grid,
            g.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fused_energy_update launch failed: cudaError {err}")
    fused_energy_update.launches += 1
    return E, Cn


def fused_energy_update_wide(E0: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
                             Mu: torch.Tensor):
    """K1w's wrapper: (E, C') as `fused_energy_update` computes them, at any
    L ≥ 1 (up to 54,012) and any row alignment."""
    if E0.device.type == "cpu":
        return fused_energy_update_reference(E0, S, C, Mu)
    n, L = _checked(E0, S, C, Mu)
    E = torch.empty_like(E0)
    Cn = torch.empty_like(E0)
    if n == 0:
        return E, Cn
    with torch.cuda.device(E0.device):
        g = wide_geometry(n, L)
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("meanfield_wide", "fused_energy_update_wide_launch", 7)(
            E0.data_ptr(), S.data_ptr(), C.data_ptr(), Mu.data_ptr(), E.data_ptr(),
            Cn.data_ptr(), n, L, _DTYPES[E0.dtype], g.tile_rows, g.q_stride, g.col_chunk,
            g.num_tiles, g.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fused_energy_update_wide launch failed: cudaError {err}")
    fused_energy_update_wide.launches += 1
    return E, Cn


fused_energy_update.launches = 0  # K1's launches, for run-time path checks
fused_energy_update_wide.launches = 0  # K1w's launches
