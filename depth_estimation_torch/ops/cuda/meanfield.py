"""Fused mean-field update: the CUDA kernels' wrappers and their plain version.

Replaces the Pallas kernel `fused_energy_update`
(the JAX package's `ops/pallas/meanfield.py`). One iteration of the
dense CRF's mean field, given the unaries E0, the filtered message
S = W·C and the compatibility-transformed beliefs C = Q·Mu:

    E  = E0 + (S − C),   Q' = softmax(−E),   C' = Q'·Mu

Four hand-written kernels serve every label count L (`kernel_for`):

- K1 (`csrc/meanfield.cu`) for L in `SUPPORTED_L`: each warp takes one
  tile of consecutive rows, loaded by coalesced 16-byte words, with Mu in
  registers; `launch_geometry` computes its tiles, grid and shared memory.
- K1w (`csrc/meanfield_wide.cu`, `fused_energy_update_wide`) for every
  other L up to `WIDE_MAX_L`: persistent blocks hold Mu in shared memory;
  each warp takes a tile of rows at a time, the next tile's loads in
  flight by `cp.async`. In bf16 the softmax runs in the registers of
  Q'·Mu on the tensor cores, q split into bf16 hi and lo terms so that it
  keeps its f32 accuracy (Mu is exact in bf16); in f32 the arithmetic is
  the plain version's, bit for bit on the H100 (PyTorch's warp-softmax
  order, Q'·Mu summed over l in order by FFMA), since the f32 pipeline's
  5e-3 px agreement with the unfused loop tolerates no other rounding.
  `wide_geometry` computes its padded width, grid and shared memory
  (`wide_config`: its instantiations).
- K1x (`csrc/meanfield_xwide.cu`, `fused_energy_update_xwide`) for L from
  `WIDE_MAX_L` + 1 to `XWIDE_MAX_L`, where Mu no longer fits in shared
  memory: one persistent block a SM, warp-specialised. Producer warps
  write E and the softmax's q (f32) for a tile of rows into one of two q
  buffers in shared memory (the next rows' E0, S, C loaded into registers
  meanwhile), while consumer warps compute the other buffer's Q'·Mu with
  Mu's tiles streamed from L2 by bulk copies (the TMA engine) through a
  ring of shared-memory stages: in bf16 by `wgmma` on the tensor cores
  (q split into three bf16 terms, so that C' keeps its f32 accuracy), in
  f32 by FFMA in the plain version's order, as K1w. `xwide_geometry`
  computes its rows a tile, pass width, grid and shared memory.
- K1xx (`csrc/meanfield_xxwide.cu`, `fused_energy_update_xxwide`) for
  every L above `XWIDE_MAX_L`, with no upper limit: one persistent block a
  SM, warp-specialised. Producer warps write q in chunks of 32 labels into
  a ring of shared-memory stages beside Mu's (32 × 512) tiles, streamed by
  bulk copies; C' is computed 512 output columns a pass, q produced again
  in each pass. bf16: a work item is a (64-row tile, pass) pair, so that
  the blocks on one tile share its rows in L2; an online softmax (the sums
  rescaled where a chunk's max grows), q in three exact bf16 terms, and two
  consumer warpgroups run `wgmma` m64n256k16 on their halves of the
  columns, both operands from shared memory. f32: a work item is a 32-row
  tile; the plain version's arithmetic (PyTorch's warp-softmax order, which
  its own softmax takes up to 2048 labels, the next tile's row statistics
  walked between this one's chunks; Q'·Mu summed over l in order by FFMA).
  `xxwide_geometry` computes its rows a tile, passes, work items, grid and
  shared memory.

The geometries are computed here, where the CPU tests reach them, and
re-checked by the C side. A CUDA tensor goes to a kernel or raises; a CPU
tensor goes to `fused_energy_update_reference`. Each wrapper counts its own
kernel's launches (`fused_energy_update.launches` for K1,
`fused_energy_update_wide.launches` for K1w,
`fused_energy_update_xwide.launches` for K1x,
`fused_energy_update_xxwide.launches` for K1xx); `launch_counts`
reads them all by kernel name and `zero_launch_counts` sets them to 0.
`fused_energy_update`, the dispatch, is the span `meanfield.update` and
counts its calls by route while a profiler records (`utils.profiling`).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ...utils.profiling import count, span

__all__ = ["fused_energy_update", "fused_energy_update_wide", "fused_energy_update_xwide",
           "fused_energy_update_xxwide", "KERNELS",
           "launch_counts", "zero_launch_counts",
           "fused_energy_update_reference", "kernel_for", "launch_geometry", "wide_geometry",
           "xwide_geometry", "xxwide_geometry", "wide_config",
           "xwide_smem_bytes", "xwide_stage_labels", "xwide_pass_cols", "xxwide_smem_bytes",
           "Geometry", "WideGeometry", "XwideGeometry", "XxwideGeometry",
           "SUPPORTED_L", "WIDE_MAX_L", "XWIDE_MAX_L"]

SUPPORTED_L = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launch geometry (must agree with csrc/meanfield.cu)
WARPS = 4  # warps in a block: 128 threads, __launch_bounds__(128, 4)
TILE_WORDS = 128  # 16-byte words of each array in a warp tile: 4 a lane

# K1w's geometry (must agree with csrc/meanfield_wide.cu)
WIDE_MAX_L = 256  # the largest L K1w serves; above it K1x
WIDE_Q_STRIDE = 12  # f32: floats a label's 8 rows take in a warp's q tile

# K1x's geometry (must agree with csrc/meanfield_xwide.cu)
XWIDE_MAX_L = 1024  # the largest L K1x serves (32 values a lane); above it K1xx
XWIDE_PAD = 64  # L is padded to a multiple of this
XWIDE_ROWS = (64, 32, 16)  # rows a tile, the largest that fits first
XWIDE_THREADS = 384  # a block: producer and consumer warps, 8 + 4 in bf16, 4 + 8 in f32
XWIDE_STAGES = {2: 4, 4: 3}  # stages of the Mu ring, by element size
XWIDE_BARRIER_BYTES = 64  # the ring's mbarriers

# K1xx's geometry (must agree with csrc/meanfield_xxwide.cu), by element size
XXWIDE_CHUNK = 32  # labels a stage: L is padded to a multiple of this
XXWIDE_ROWS = {2: 64, 4: 32}  # rows a tile
XXWIDE_PASS_COLS = 512  # output columns a pass (bf16: 256 a consumer warpgroup)
XXWIDE_STAGES = {2: 5, 4: 3}  # stages of the ring
XXWIDE_THREADS = 384  # a block: 4 producer warps, 8 consumer warps
XXWIDE_AUX_BYTES = 640  # bf16: a stage's row factors, 1 / sums and flags
MAX_SMEM = 232448  # the H100's opt-in limit a block (227 KB)

# the counter of each route of `fused_energy_update`: a kernel's name, or the plain version
_ROUTE_COUNTERS = {r: f"meanfield.update.{r}" for r in ("plain", "K1", "K1w", "K1x", "K1xx")}


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
    SUPPORTED_L, 'K1w' for every other L up to WIDE_MAX_L, 'K1x' from
    there up to XWIDE_MAX_L, 'K1xx' above it."""
    if L < 1:
        raise ValueError(f"L={L}: the update needs at least one label")
    if L in SUPPORTED_L:
        return "K1"
    if L <= WIDE_MAX_L:
        return "K1w"
    return "K1x" if L <= XWIDE_MAX_L else "K1xx"


def wide_config(elt: int, lp: int) -> dict:
    """K1w's instantiation for `elt`-byte values at LP = `lp` columns (its
    `Cfg<T, LP>`): rows a warp's tile (bf16: one MMA row tile of 16; f32:
    8), warps a block, blocks a SM (its __launch_bounds__), output columns
    a block (`nb`) and the dynamic shared memory: Mu (bf16: its columns
    transposed, rows padded to `stride` elements; f32: LP rows of nb), then
    a staging buffer a warp (E0, S and C of a tile) and, in f32, a warp's q
    tile (LP labels of WIDE_Q_STRIDE floats)."""
    if elt == 2:
        cfg = dict(rows=16, warps={32: 8, 64: 8, 128: 12, 256: 3}[lp],
                   min_blocks=2 if lp <= 64 else 1, nb=lp,
                   stride=lp if lp % 64 == 32 else lp + 32)
        mu, q = cfg["nb"] * cfg["stride"] * 2, 0
    else:
        cfg = dict(rows=8, warps={32: 8, 64: 16, 128: 20, 256: 8}[lp],
                   min_blocks=2 if lp <= 32 else 1, nb=min(lp, 128))
        mu, q = lp * cfg["nb"] * 4, lp * WIDE_Q_STRIDE * 4
    staged = 3 * cfg["rows"] * lp * elt if elt == 2 else 0
    cfg["smem_bytes"] = mu + cfg["warps"] * (staged + q)
    return cfg


@dataclass(frozen=True)
class WideGeometry:
    """A launch of K1w: a grid of `grid_x` × `grid_y` blocks of `warps`
    warps. L is padded to `lp` columns (32, 64, 128 or 256: the kernel's
    instantiation); grid_y blocks of `nb` output columns each hold their
    part of Mu, and each warp its buffers, in `smem_bytes` of dynamic
    shared memory. The grid_x persistent blocks of a column block (at most
    `min_blocks` on an SM) walk the `num_tiles` tiles of `rows` rows, one
    warp a tile at a time."""

    lp: int
    rows: int
    nb: int
    warps: int
    min_blocks: int
    num_tiles: int
    grid_x: int
    grid_y: int
    smem_bytes: int


def wide_geometry(n: int, L: int, elt: int, sms: int) -> WideGeometry:
    """K1w's geometry for (n, L) rows of `elt`-byte values on a card of
    `sms` SMs: LP the power of two ≥ max(L, 32), as many persistent blocks
    as the SMs hold (`min_blocks` each) or the tiles need. Raises above
    WIDE_MAX_L, where Mu's planes leave no room (K1x's L)."""
    if n < 1:
        raise ValueError(f"n={n}: the kernel needs at least one row")
    if not 1 <= L <= WIDE_MAX_L:
        raise ValueError(f"L={L}: K1w serves 1 to {WIDE_MAX_L} labels")
    lp = 32
    while lp < L:
        lp *= 2
    cfg = wide_config(elt, lp)
    num_tiles = -(-n // cfg["rows"])
    grid_x = min(sms * cfg["min_blocks"], -(-num_tiles // cfg["warps"]))
    return WideGeometry(lp, cfg["rows"], cfg["nb"], cfg["warps"], cfg["min_blocks"], num_tiles,
                        grid_x, lp // cfg["nb"], cfg["smem_bytes"])


def xwide_stage_labels(elt: int, rows: int) -> int:
    """Labels (rows of Mu) a stage of K1x's Mu ring holds: 32 in bf16; in
    f32 32 where a tile is 64 rows, else 16."""
    return 32 if elt == 2 or rows == 64 else 16


def xwide_pass_cols(elt: int, rows: int) -> int:
    """Output columns K1x computes a pass (a stage's columns of Mu): 160 in
    bf16 where a tile is 64 rows (LP = 320 in two passes), else 64."""
    return 160 if elt == 2 and rows == 64 else 64


def xwide_smem_bytes(elt: int, rows: int, lp: int) -> int:
    """K1x's dynamic shared memory: two q buffers in f32 (bf16 state:
    `rows` rows of lp + 8 values; f32 state: lp labels of rows + 4 values),
    the Mu ring (XWIDE_STAGES stages of `xwide_stage_labels` rows of
    `xwide_pass_cols` columns) and the ring's mbarriers."""
    q = rows * (lp + 8) * 4 if elt == 2 else lp * (rows + 4) * 4
    stage = xwide_stage_labels(elt, rows) * xwide_pass_cols(elt, rows) * elt
    return 2 * q + XWIDE_STAGES[elt] * stage + XWIDE_BARRIER_BYTES


@dataclass(frozen=True)
class XwideGeometry:
    """A launch of K1x: `grid` persistent blocks of `threads` threads
    (producer warps, then consumer warps) walk the `num_tiles` tiles of
    `rows` rows; L is padded to `lp`; a pass computes `pass_cols` output
    columns, so Mu's stage images (the wrapper's scratch) hold lp rows of
    `mu_cols` columns; `smem_bytes` of dynamic shared memory
    (`xwide_smem_bytes`)."""

    lp: int
    rows: int
    pass_cols: int
    mu_cols: int
    threads: int
    num_tiles: int
    grid: int
    smem_bytes: int


def xwide_geometry(n: int, L: int, elt: int, sms: int) -> XwideGeometry:
    """K1x's geometry for (n, L) rows of `elt`-byte values on a card of
    `sms` SMs: LP = L padded to a multiple of XWIDE_PAD, the most rows a
    tile (XWIDE_ROWS) whose two q buffers and Mu ring fit the card's shared
    memory, one block a SM or a tile. Raises above XWIDE_MAX_L (K1xx's
    labels)."""
    if n < 1:
        raise ValueError(f"n={n}: the kernel needs at least one row")
    if not 1 <= L <= XWIDE_MAX_L:
        raise ValueError(f"L={L}: K1x serves 1 to {XWIDE_MAX_L} labels")
    lp = -(-L // XWIDE_PAD) * XWIDE_PAD
    rows = next(r for r in XWIDE_ROWS if xwide_smem_bytes(elt, r, lp) <= MAX_SMEM)
    num_tiles = -(-n // rows)
    pc = xwide_pass_cols(elt, rows)
    return XwideGeometry(lp, rows, pc, -(-lp // pc) * pc, XWIDE_THREADS, num_tiles,
                         min(sms, num_tiles), xwide_smem_bytes(elt, rows, lp))


def xxwide_smem_bytes(elt: int) -> int:
    """K1xx's dynamic shared memory, the same at every L: XXWIDE_STAGES
    stages of a q chunk (bf16: three bf16 terms of XXWIDE_ROWS rows ×
    XXWIDE_CHUNK labels; f32: XXWIDE_CHUNK labels of the rows + 4 floats),
    a Mu tile (XXWIDE_CHUNK × XXWIDE_PASS_COLS) and, in bf16, the rows'
    factors and flags (XXWIDE_AUX_BYTES); in f32 the row statistics of two
    tiles (a float2 a row); and the ring's full and empty mbarriers."""
    rows, stages = XXWIDE_ROWS[elt], XXWIDE_STAGES[elt]
    mu = XXWIDE_CHUNK * XXWIDE_PASS_COLS * elt
    if elt == 2:
        stage, stats = 3 * rows * XXWIDE_CHUNK * 2 + mu + XXWIDE_AUX_BYTES, 0
    else:
        stage, stats = XXWIDE_CHUNK * (rows + 4) * 4 + mu, 2 * rows * 8
    return stages * stage + stats + 2 * stages * 8


@dataclass(frozen=True)
class XxwideGeometry:
    """A launch of K1xx: `grid` persistent blocks of `threads` threads
    (producer warps, then consumer warps) walk `num_items` work items: in
    bf16 the (tile, pass) pairs, in f32 the tiles (each all its passes), of
    `num_tiles` tiles of `rows` rows. L is padded to `lp` labels, `lp` /
    XXWIDE_CHUNK stages a pass; `passes` passes of `pass_cols` output
    columns, so Mu's stage images (the wrapper's scratch) hold lp rows of
    `mu_cols` columns; `smem_bytes` of dynamic shared memory
    (`xxwide_smem_bytes`)."""

    lp: int
    rows: int
    pass_cols: int
    passes: int
    mu_cols: int
    threads: int
    num_tiles: int
    num_items: int
    grid: int
    smem_bytes: int


def xxwide_geometry(n: int, L: int, elt: int, sms: int) -> XxwideGeometry:
    """K1xx's geometry for (n, L) rows of `elt`-byte values on a card of
    `sms` SMs: LP = L padded to XXWIDE_CHUNK, XXWIDE_ROWS rows a tile, L /
    XXWIDE_PASS_COLS passes rounded up, one block a SM or a work item. Its
    shared memory does not grow with L, so any L ≥ 1 has a geometry (the
    dispatch sends it XWIDE_MAX_L + 1 and up)."""
    if n < 1:
        raise ValueError(f"n={n}: the kernel needs at least one row")
    if L < 1:
        raise ValueError(f"L={L}: the kernel needs at least one label")
    lp = -(-L // XXWIDE_CHUNK) * XXWIDE_CHUNK
    rows, cols = XXWIDE_ROWS[elt], XXWIDE_PASS_COLS
    passes = -(-L // cols)
    num_tiles = -(-n // rows)
    items = num_tiles * passes if elt == 2 else num_tiles
    return XxwideGeometry(lp, rows, cols, passes, passes * cols, XXWIDE_THREADS, num_tiles, items,
                          min(sms, items), xxwide_smem_bytes(elt))


def fused_energy_update_reference(E0, S, C, Mu):
    """Plain PyTorch version of the kernel: computes in f32 and rounds each
    output once to the I/O dtype. Returns (E, C')."""
    dt = E0.dtype
    E = E0.float() + (S.float() - C.float())
    Q = torch.softmax(-E, dim=-1)
    return E.to(dt), (Q @ Mu.float()).to(dt)


def _lib(name: str, symbol: str, ints: int, pointers: int = 6):
    from ...utils.build import load_library

    fn = getattr(load_library(name), symbol)
    # without argtypes ctypes would pass each pointer as a 32-bit int
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_longlong] + [ctypes.c_int] * ints
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


def _launch(wrapper, library: str, E0, S, C, Mu, geometry):
    """What the four wrappers share: the plain version for a CPU tensor,
    uncounted; else the arrays checked, E and C' allocated and `library`'s
    `<wrapper>_launch` called with the launch's ints that `geometry(n, L,
    elt)` gives (and, where it gives a scratch size, a scratch array after
    Mu), raising on its error code and counting the launch on
    `wrapper.launches`."""
    if E0.device.type == "cpu":
        return fused_energy_update_reference(E0, S, C, Mu)
    n, L = _checked(E0, S, C, Mu)
    E = torch.empty_like(E0)
    Cn = torch.empty_like(E0)
    if n == 0:
        return E, Cn
    with torch.cuda.device(E0.device):
        ints, scratch = geometry(n, L, E0.element_size())
        extra = [torch.empty(scratch, dtype=E0.dtype, device=E0.device)] if scratch else []
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib(library, f"{wrapper.__name__}_launch", 2 + len(ints), 6 + len(extra))(
            E0.data_ptr(), S.data_ptr(), C.data_ptr(), Mu.data_ptr(),
            *[x.data_ptr() for x in extra], E.data_ptr(), Cn.data_ptr(), n, L,
            _DTYPES[E0.dtype], *ints, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError {err}")
    wrapper.launches += 1
    return E, Cn


def fused_energy_update(E0: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
                        Mu: torch.Tensor):
    """(E, C') from (n, L) E0, S, C and (L, L) Mu, all of one dtype
    (float32 or bfloat16) and on one device. On the card, L in SUPPORTED_L
    launches K1, every other L up to WIDE_MAX_L K1w, L up to XWIDE_MAX_L
    K1x and a larger L K1xx (`kernel_for`); on the CPU the plain version
    runs. Each call runs inside the span `meanfield.update` and counts 1
    on `meanfield.update` and on `meanfield.update.<route>` (the kernel's
    name, or `plain`), while a profiler records."""
    route = "plain" if E0.device.type == "cpu" else kernel_for(_checked(E0, S, C, Mu)[1])
    count("meanfield.update", 1)
    count(_ROUTE_COUNTERS[route], 1)
    with span("meanfield.update"):
        if route == "plain":
            return fused_energy_update_reference(E0, S, C, Mu)
        if route != "K1":
            return {"K1w": fused_energy_update_wide, "K1x": fused_energy_update_xwide,
                    "K1xx": fused_energy_update_xxwide}[route](E0, S, C, Mu)
        for name, x in (("E0", E0), ("S", S), ("C", C), ("Mu", Mu)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")

        def geometry(n, L, elt):
            g = launch_geometry(n, L, elt)
            return (g.tile_rows, g.num_tiles, g.grid, g.smem_bytes), 0
        return _launch(fused_energy_update, "meanfield", E0, S, C, Mu, geometry)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_energy_update_wide(E0: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
                             Mu: torch.Tensor):
    """K1w's wrapper: (E, C') as `fused_energy_update` computes them, at any
    L from 1 to WIDE_MAX_L and any row alignment (rows of a multiple of 16
    bytes, 16-byte aligned, move as 16-byte words; others value by value)."""
    def geometry(n, L, elt):
        g = wide_geometry(n, L, elt, _sms(E0.device))
        return (g.lp, g.grid_x, g.grid_y, g.smem_bytes), 0
    return _launch(fused_energy_update_wide, "meanfield_wide", E0, S, C, Mu, geometry)


def fused_energy_update_xwide(E0: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
                              Mu: torch.Tensor):
    """K1x's wrapper: (E, C') as `fused_energy_update` computes them, at any
    L from 1 to XWIDE_MAX_L (it serves WIDE_MAX_L + 1 and up) and any row
    alignment (rows of a multiple of 16 bytes, 16-byte aligned, move as
    16-byte words; others value by value). Its scratch holds Mu's stage
    images."""
    def geometry(n, L, elt):
        g = xwide_geometry(n, L, elt, _sms(E0.device))
        return (g.lp, g.rows, g.grid, g.smem_bytes), g.lp * g.mu_cols
    return _launch(fused_energy_update_xwide, "meanfield_xwide", E0, S, C, Mu, geometry)


def fused_energy_update_xxwide(E0: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
                               Mu: torch.Tensor):
    """K1xx's wrapper: (E, C') as `fused_energy_update` computes them, at any
    L ≥ 1 (it serves XWIDE_MAX_L + 1 and up) and any row alignment (bf16
    rows move by 16 or 8 bytes where the arrays' alignment and L allow,
    else value by value). Its scratch holds Mu's stage images."""
    def geometry(n, L, elt):
        g = xxwide_geometry(n, L, elt, _sms(E0.device))
        return (g.lp, g.rows, g.passes, g.grid, g.smem_bytes), g.lp * g.mu_cols
    return _launch(fused_energy_update_xxwide, "meanfield_xxwide", E0, S, C, Mu, geometry)


fused_energy_update.launches = 0  # K1's launches, for run-time path checks
fused_energy_update_wide.launches = 0  # K1w's launches
fused_energy_update_xwide.launches = 0  # K1x's launches
fused_energy_update_xxwide.launches = 0  # K1xx's launches

# the wrappers by kernel name
KERNELS = {"K1": fused_energy_update, "K1w": fused_energy_update_wide,
           "K1x": fused_energy_update_xwide, "K1xx": fused_energy_update_xxwide}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def zero_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
