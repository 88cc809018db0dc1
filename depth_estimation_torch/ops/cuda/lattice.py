"""Lattice apply on the card: the untiled splat and slice as CUDA kernels,
their wrappers and their plain versions.

The untiled plan's sparse incidence S (n × C, d+1 weights a row: pixel i
touches slot[i, r] with weight bary[i, r]) is applied by two hand-written
kernels of `csrc/lattice_apply.cu`, each reading its operand in place:

- the slice (`lattice_slice`) computes S·V by gathering rows: a team of
  lanes a pixel gathers its d+1 rows of the vertex table and sums them in
  the plain version's order with separately rounded products and sums, so
  it is bit for bit `slice_untiled_reference`. With `shifted` it writes
  each row shifted to a minimum of 0 and rounded to bf16, the minimum
  taken across the team's lanes, bit for bit `shift_rows_bf16` of the f32
  slice (`slice_untiled_shifted`, the mean field's message);
- the splat (`lattice_splat`) computes Sᵀ·x as a segmented reduce over the
  entries sorted by slot (the plan's `entry_order`, `entry_weight`,
  `slot_start` and `chunk_start`, built by `build_plan`): each slot's
  entries are cut into chunks of CHUNK, a team a chunk; a slot of one chunk
  is stored into the zeroed f32 table (f64 for f64 values) and a second
  pass adds a longer slot's chunk sums in order. Each sum's order is fixed
  by its slot's entries alone, so the splat is deterministic and does not
  depend on how a plan numbers its slots; the table is rounded to the
  source's dtype. Its sums are f32 sums in another order than
  `splat_untiled_reference`'s.

Neither replaces a Pallas kernel: the JAX package leaves the splat and slice
to XLA. `apply_geometry` computes a launch's geometry (values a lane, lanes
a team, column passes, blocks), which the C side re-checks.

`splat_untiled` and `slice_untiled` route by device: a CPU tensor takes the
plain version; a CUDA tensor takes the kernel through a
`torch.autograd.Function` whose backward is the other kernel (the slice
without the scale for the splat, the splat with it, summing the overflow
entries into row C, for the slice), or raises. `slice_untiled_shifted`
routes alike, without a backward. The plan's tensors are
constants of both. Each kernel's wrapper counts its launches
(`lattice_splat.launches`, `lattice_slice.launches`, the shifted ones also
in `lattice_slice.shifted_launches`); `launch_counts` reads the first two by
kernel name and `zero_launch_counts` sets all three to 0.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

__all__ = ["lattice_splat", "lattice_slice", "splat_untiled", "slice_untiled",
           "slice_untiled_shifted", "splat_untiled_reference", "slice_untiled_reference",
           "shift_rows_bf16", "slice_scale", "apply_geometry", "ApplyGeometry", "KERNELS",
           "launch_counts", "zero_launch_counts", "THREADS", "CHUNK"]

# the value and weight dtypes the kernels take, by the C side's codes
_VALUES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_WEIGHTS = {torch.float32: 0, torch.float64: 2}
# those the shifted slice takes: the bf16 mean field's table, float32 weights
_SHIFTED_VALUES = {torch.bfloat16: 1}
_SHIFTED_WEIGHTS = {torch.float32: 0}

# geometry (must agree with csrc/lattice_apply.cu)
THREADS = 256  # a block
CHUNK = 256  # entries of a slot a team walks in the splat
VEC = 8  # values a lane moves at once (16-byte words) where L and the alignment allow
_INT32_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class ApplyGeometry:
    """A launch of either kernel: `teams` teams of `team` lanes (a power of
    two up to 32), each lane moving `vec` values of a row at once, a row in
    `passes` column passes of team·vec values, in `grid` blocks of THREADS
    threads. The splat's team walks a chunk of up to CHUNK entries of one
    slot, the slice's a pixel."""

    vec: int
    team: int
    passes: int
    teams: int
    grid: int


def apply_geometry(teams: int, L: int, vec: int) -> ApplyGeometry:
    """The geometry of `teams` teams over rows of L values, `vec` (VEC or 1)
    values a lane: the fewest lanes, a power of two up to 32, that cover L."""
    if teams < 1 or L < 1:
        raise ValueError(f"teams={teams}, L={L}: a launch needs at least one of each")
    if vec not in (1, VEC) or L % vec:
        raise ValueError(f"vec={vec} at L={L}: want 1, or {VEC} dividing L")
    team = 1
    while team < 32 and team * vec < L:
        team *= 2
    return ApplyGeometry(vec, team, -(-L // (team * vec)), teams, -(-teams * team // THREADS))


def _vec(L: int, *arrays: torch.Tensor) -> int:
    """VEC where L is a multiple of it and every row array starts on a
    16-byte boundary (its rows then do too), else 1."""
    if L % VEC == 0 and all(a.data_ptr() % 16 == 0 for a in arrays):
        return VEC
    return 1


def slice_scale(d: int) -> float:
    """The slice's scale 1/(1+2^-d)."""
    return 1.0 / (1.0 + 2.0 ** (-d))


def _lib(symbol: str, argtypes: list):
    from ...utils.build import load_library

    fn = getattr(load_library("lattice_apply"), symbol)
    fn.argtypes = argtypes  # without them ctypes would pass each pointer as a 32-bit int
    fn.restype = ctypes.c_int
    return fn


_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_SPLAT_ARGS = [_P] * 7 + [_I] * 9 + [_LL, _I, _D, _P]
_SLICE_ARGS = [_P] * 4 + [_I] * 12 + [_LL, _D, _P]


def _on_card(name: str, x: torch.Tensor, dtypes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: unsupported dtype {x.dtype} (want one of {list(dtypes)})")


def lattice_splat(src: torch.Tensor, entry_order: torch.Tensor, entry_weight: torch.Tensor,
                  slot_start: torch.Tensor, chunk_start: torch.Tensor, scale: float = 1.0,
                  sentinel: bool = False) -> torch.Tensor:
    """The splat kernel: the (C+1, L) vertex table, in src's dtype, of the
    contiguous (n, L) `src` through an untiled plan's N = n·(d+1) entries in
    slot order (`entry_order`, int32, entry = r·n + i; `entry_weight`, their
    weights; `slot_start`, (C+1,) int32, where each slot's begin;
    `chunk_start`, (C+1,) int32, its first chunk of CHUNK entries), each sum
    times `scale`. Row C is zero, the overflow entries (past slot_start[C])
    dropped, unless `sentinel` sums them into it. CUDA tensors only
    (float32, bfloat16 or float64 values; float32 or float64 weights)."""
    _on_card("src", src, _VALUES)
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError(f"src: want a contiguous (n, L), got {tuple(src.shape)}")
    if entry_order is None or entry_weight is None or slot_start is None or chunk_start is None:
        raise ValueError("the plan has no slot-sorted entry table (a tiled plan), which the "
                         "splat kernel walks")
    _on_card("entry_weight", entry_weight, _WEIGHTS)
    n, L = src.shape
    N, C = entry_order.shape[0], slot_start.shape[0] - 1
    for name, x, dtype, shape in (("entry_order", entry_order, torch.int32, (N,)),
                                  ("entry_weight", entry_weight, entry_weight.dtype, (N,)),
                                  ("slot_start", slot_start, torch.int32, (C + 1,)),
                                  ("chunk_start", chunk_start, torch.int32, (C + 1,))):
        if (x.dtype != dtype or tuple(x.shape) != shape or x.device != src.device
                or not x.is_contiguous()):
            raise ValueError(f"{name}: want a contiguous {shape} {dtype} on {src.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if n and (N % n or N > _INT32_MAX - CHUNK):
        raise ValueError(f"src ({n}, {L}) and {N} entries: want d+1 entries a pixel, fewer "
                         "than 2^31 in all")
    acc = torch.float64 if src.dtype == torch.float64 else torch.float32
    table = torch.zeros(C + 1, L, dtype=acc, device=src.device)
    if n == 0 or L == 0:
        return table.to(src.dtype)
    # the chunks' upper bound: one a CHUNK entries and one more a slot
    g = apply_geometry(-(-N // CHUNK) + min(C + 1, N), L, _vec(L, src, table))
    part = torch.empty(g.teams, L, dtype=acc, device=src.device)  # chunk sums of long slots
    with torch.cuda.device(src.device):
        err = _lib("lattice_splat_launch", _SPLAT_ARGS)(
            src.data_ptr(), entry_order.data_ptr(), entry_weight.data_ptr(),
            slot_start.data_ptr(), chunk_start.data_ptr(), table.data_ptr(), part.data_ptr(), n,
            L, C, N, _WEIGHTS[entry_weight.dtype],
            _VALUES[src.dtype], g.vec, g.team, g.passes, g.grid, int(sentinel), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lattice_splat launch failed: cudaError {err}")
    lattice_splat.launches += 1
    return table.to(src.dtype)


def lattice_slice(vals: torch.Tensor, slot: torch.Tensor, bary: torch.Tensor,
                  scale: float, shifted: bool = False) -> torch.Tensor:
    """The slice kernel: (n, L) = scale · Σ_r bary[:, r] · vals[slot[:, r]]
    from the contiguous (C+1, L) vertex table `vals` and the plan's (n, d+1)
    slots and weights (any strides), in the promoted dtype of weights and
    values, bit for bit `slice_untiled_reference`. CUDA tensors only
    (float32, bfloat16 or float64 values; float32 or float64 weights).

    `shifted`: each row shifted to a minimum of 0 and rounded to bfloat16,
    bit for bit `shift_rows_bf16` of the above (bfloat16 values, float32
    weights only; rows of up to 7168 values, 7264 at one value a lane:
    their sums wait in 227 KB of shared memory a block)."""
    _on_card("vals", vals, _SHIFTED_VALUES if shifted else _VALUES)
    _on_card("bary", bary, _SHIFTED_WEIGHTS if shifted else _WEIGHTS)
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError(f"vals: want a contiguous (C+1, L), got {tuple(vals.shape)}")
    if (bary.dim() != 2 or slot.dtype != torch.int64 or slot.shape != bary.shape
            or {slot.device, bary.device} != {vals.device}):
        raise ValueError(f"slot, bary: want (n, d+1) int64 and weights on {vals.device}, got "
                         f"{tuple(slot.shape)} {slot.dtype} on {slot.device}, "
                         f"{tuple(bary.shape)} on {bary.device}")
    n, d1 = bary.shape
    L = vals.shape[1]
    # the kernel reads the slots' low words and indexes both tables in int32
    last = max((n - 1) * x.stride(0) + (d1 - 1) * x.stride(1) for x in (slot, bary))
    if vals.shape[0] > _INT32_MAX or last > _INT32_MAX:
        raise ValueError(f"{vals.shape[0]} slots, or an offset of {last} into the plan's "
                         "tables: the kernel takes fewer than 2^31")
    dtype = torch.bfloat16 if shifted else torch.promote_types(bary.dtype, vals.dtype)
    out = torch.empty(n, L, dtype=dtype, device=vals.device)
    if n == 0 or L == 0:
        return out
    g = apply_geometry(n, L, _vec(L, vals, out))
    symbol = "lattice_slice_shifted_launch" if shifted else "lattice_slice_launch"
    with torch.cuda.device(vals.device):
        err = _lib(symbol, _SLICE_ARGS)(
            vals.data_ptr(), slot.data_ptr(), bary.data_ptr(), out.data_ptr(), n, L, d1,
            slot.stride(0), slot.stride(1), bary.stride(0), bary.stride(1),
            _WEIGHTS[bary.dtype], _VALUES[vals.dtype], g.vec, g.team, g.passes, g.grid,
            float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lattice_slice launch failed: cudaError {err}")
    lattice_slice.launches += 1
    if shifted:
        lattice_slice.shifted_launches += 1
    return out


lattice_splat.launches = 0  # the splat kernel's launches, for run-time path checks
lattice_slice.launches = 0  # the slice kernel's launches, shifted or not
lattice_slice.shifted_launches = 0  # those of the shifted slice

# the wrappers by kernel name
KERNELS = {"splat": lattice_splat, "slice": lattice_slice}


def launch_counts() -> dict[str, int]:
    """Each lattice kernel's launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def zero_launch_counts() -> None:
    """Set every lattice kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    lattice_slice.shifted_launches = 0


def splat_untiled_reference(plan, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch splat of an untiled plan: the (n, d+1, L) products,
    summed into the (C+1, L) table by `index_add_` in f32 (f64 for f64
    values), row C zero, rounded to src's dtype."""
    L = src.shape[1]
    acc = torch.promote_types(src.dtype, torch.float32)
    contrib = (plan.bary[:, :, None] * src[:, None, :]).to(acc)  # (n, d+1, L)
    vals = torch.zeros(plan.capacity + 1, L, dtype=acc, device=src.device)
    vals.index_add_(0, plan.slot.reshape(-1), contrib.reshape(-1, L))
    vals[plan.capacity] = 0
    return vals.to(src.dtype)


def slice_untiled_reference(plan, vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch slice of an untiled plan: vertex values back to
    pixels with barycentric weights, summed over r in order, scaled by
    1/(1+2^-d)."""
    out = plan.bary[:, 0, None] * vals[plan.slot[:, 0]]
    for r in range(1, plan.d + 1):
        out = out + plan.bary[:, r, None] * vals[plan.slot[:, r]]
    return out * slice_scale(plan.d)


def shift_rows_bf16(S: torch.Tensor) -> torch.Tensor:
    """Each row of S shifted to a minimum of 0 in S's dtype and rounded to
    bfloat16: the shifted slice's epilogue in plain PyTorch."""
    out = torch.empty(S.shape, dtype=torch.bfloat16, device=S.device)
    return torch.sub(S, S.amin(1, keepdim=True), out=out)


class _Splat(torch.autograd.Function):
    """The splat kernel; its backward is the slice kernel without the scale,
    through row C set to zero (the forward's row C is a constant)."""

    @staticmethod
    def forward(ctx, src, plan):
        ctx.plan, ctx.dtype = plan, src.dtype
        return lattice_splat(src, plan.entry_order, plan.entry_weight, plan.slot_start,
                             plan.chunk_start)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        g[ctx.plan.capacity] = 0
        return lattice_slice(g, ctx.plan.slot, ctx.plan.bary, 1.0).to(ctx.dtype), None


class _Slice(torch.autograd.Function):
    """The slice kernel; its backward is the splat kernel with the scale,
    the overflow entries summed into row C (which they gather)."""

    @staticmethod
    def forward(ctx, vals, plan):
        ctx.plan, ctx.dtype = plan, vals.dtype
        return lattice_slice(vals, plan.slot, plan.bary, slice_scale(plan.d))

    @staticmethod
    def backward(ctx, g):
        p = ctx.plan
        grad = lattice_splat(g.contiguous(), p.entry_order, p.entry_weight, p.slot_start,
                             p.chunk_start, scale=slice_scale(p.d), sentinel=True)
        return grad.to(ctx.dtype), None


def splat_untiled(plan, src: torch.Tensor) -> torch.Tensor:
    """(n, L) → (C+1, L) vertex values of an untiled plan; row C is the zero
    sentinel. A CPU tensor takes the plain version, a CUDA tensor the
    kernel (or raises)."""
    if src.device.type == "cpu":
        return splat_untiled_reference(plan, src)
    return _Splat.apply(src.contiguous(), plan)


def slice_untiled(plan, vals: torch.Tensor) -> torch.Tensor:
    """(C+1, L) vertex values of an untiled plan back to (n, L) pixels. A
    CPU tensor takes the plain version, a CUDA tensor the kernel (or
    raises)."""
    if vals.device.type == "cpu":
        return slice_untiled_reference(plan, vals)
    return _Slice.apply(vals.contiguous(), plan)


def slice_untiled_shifted(plan, vals: torch.Tensor) -> torch.Tensor:
    """(C+1, L) vertex values of an untiled plan back to (n, L) pixels, each
    row shifted to a minimum of 0 and rounded to bfloat16, for a caller that
    needs no gradient. A CPU tensor takes the plain version (the slice, then
    `shift_rows_bf16`), a CUDA tensor the shifted slice kernel (or raises);
    both give the same bits."""
    if vals.requires_grad:
        raise ValueError("the shifted slice has no backward: vals must not require a gradient")
    if vals.device.type == "cpu":
        return shift_rows_bf16(slice_untiled_reference(plan, vals))
    return lattice_slice(vals.contiguous(), plan.slot, plan.bary, slice_scale(plan.d),
                         shifted=True)
