"""The PyTorch port's CUDA kernels (K1, K1w, K1x and K1xx, the
lattice apply's splat and slice, and the stereo cost volume) against their
plain versions, on a card.

These tests import neither JAX nor the JAX package, so a GPU machine without
JAX runs them, skipping the JAX-specific conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips (a kernel has no CPU mode)."""
import numpy as np
import pytest
import torch

from depth_estimation_torch.ops import costvolume as CV
from depth_estimation_torch.ops import permutohedral as P
from depth_estimation_torch.ops.cuda import costvolume as CVK
from depth_estimation_torch.ops.cuda import lattice as LK
from depth_estimation_torch.ops.cuda import meanfield as T
from depth_estimation_torch.utils import profiling


def _inputs(seed, n, L):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, L).astype(np.float32) * 10, rs.randn(n, L).astype(np.float32),
            rs.rand(n, L).astype(np.float32), rs.rand(L, L).astype(np.float32))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _check(arrays, dtype):
    """One launch of the kernel that `kernel_for(L)` names, counted once on
    its own counter, against the plain version on the same inputs."""
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in arrays]
    before = T.launch_counts()
    E_k, C_k = T.fused_energy_update(*arrays)
    torch.cuda.synchronize()
    want = T.kernel_for(arrays[0].shape[1])
    assert {k: n - before[k] for k, n in T.launch_counts().items()} == {
        k: int(k == want) for k in T.KERNELS}
    E_r, C_r = T.fused_energy_update_reference(*arrays)
    if dtype == torch.float32:
        torch.testing.assert_close(E_k, E_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(C_k, C_r, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(E_r.float().abs().clamp_min(1e-30))) - 7)
        assert bool(((E_k.float() - E_r.float()).abs() <= ulp).all())
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,L", [(110592, 16), (110585, 16), (4099, 8), (1000, 32),
                                 (300, 64)])
def test_cuda_kernel_matches_plain_version(n, L, dtype):
    _needs_card()
    _check(_inputs(3, n, L), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", T.SUPPORTED_L)
@pytest.mark.parametrize("case", ["1", "33", "tile-1", "tile+1", "3 tiles+5", "wave+5"])
def test_cuda_kernel_at_the_edges_of_its_geometry(case, L, dtype):
    """Row counts around a warp tile (from 8 to 128 rows, whichever L and
    dtype), a ragged tile after three full ones, and one full wave of the
    card's block slots plus 5 rows; each n's own geometry is launched."""
    _needs_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    elt = torch.tensor([], dtype=dtype).element_size()
    tile = T.launch_geometry(1, L, elt).tile_rows
    wave = sms * 4 * T.WARPS * tile  # __launch_bounds__(128, 4): 4 blocks an SM
    n = {"tile-1": tile - 1, "tile+1": tile + 1, "3 tiles+5": 3 * tile + 5,
         "wave+5": wave + 5}.get(case) or int(case)
    g = T.launch_geometry(n, L, elt)
    assert g.tile_rows == tile and n - (g.num_tiles - 1) * tile == (n - 1) % tile + 1
    _check(_inputs(4, n, L), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", T.SUPPORTED_L + (3, 24, 100, 128, 256, 300, 1025, 1100, 2048, 4099))
def test_cuda_kernel_subtracts_the_max_from_large_energies(L, dtype):
    """Energies of magnitude ~1e3: exp(-E) alone would underflow to 0 in f32."""
    _needs_card()
    e0, s, c, mu = _inputs(5, 5000, L)
    _check((e0 * 100 + 500, s * 1e3, c * 1e3, mu), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 3, 12, 24, 100, 128, 256])
@pytest.mark.parametrize("n", [1, 7, 110585])
def test_wide_kernel_matches_plain_version(n, L, dtype):
    """K1w, which serves every L outside SUPPORTED_L, at ragged row counts."""
    _needs_card()
    _check(_inputs(6, n, L), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [15, 17, 31, 33, 63, 65, 127, 129, 255, 256, 257])
def test_wide_kernel_at_the_mma_tile_edges(L, dtype):
    """L around the padded widths LP (32, 64, 128, 256), the MMA's 16
    labels and K1w's limit (257 goes to K1x), at a ragged row count."""
    _needs_card()
    _check(_inputs(8, 4099, L), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [24, 128, 256])
@pytest.mark.parametrize("case", ["1", "15", "16", "17", "block-1", "block+1", "wave+5"])
def test_wide_kernel_at_the_edges_of_its_geometry(case, L, dtype):
    """Row counts around a warp's tile (16 rows in bf16, 8 in f32), around
    one block's warps' tiles, and one wave of the persistent grid (every
    warp one tile) plus 5 rows, so that some warps take a second, ragged
    tile."""
    _needs_card()
    elt = torch.tensor([], dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = T.wide_geometry(1 << 24, L, elt, sms)
    block = g.warps * g.rows
    n = {"block-1": block - 1, "block+1": block + 1,
         "wave+5": g.grid_x * block + 5}.get(case) or int(case)
    _check(_inputs(9, n, L), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [3, 12, 100, 128, 256])
def test_wide_kernel_takes_rows_off_16_byte_alignment(L, dtype):
    """Contiguous arrays that start one element into their storage: K1w
    reads and writes value by value (K1 would refuse them)."""
    _needs_card()
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in _inputs(7, 1001, L)]
    shifted = []
    for a in arrays:
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
        shifted.append(buf[1:].view(a.shape).copy_(a))
    assert shifted[0].data_ptr() % 16 == shifted[0].element_size()
    E_k, C_k = T.fused_energy_update_wide(*shifted)
    E_r, C_r = T.fused_energy_update_reference(*arrays)
    if dtype == torch.float32:
        torch.testing.assert_close(E_k, E_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(C_k, C_r, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(E_r.float().abs().clamp_min(1e-30))) - 7)
        assert bool(((E_k.float() - E_r.float()).abs() <= ulp).all())
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)


def _check_direct(fn, arrays, dtype):
    """One launch of `fn` (a kernel's own wrapper), counted once on its own
    counter, against the plain version on the same inputs (which may lie
    off 16-byte alignment)."""
    before = fn.launches
    E_k, C_k = fn(*arrays)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    E_r, C_r = T.fused_energy_update_reference(*[a.contiguous() for a in arrays])
    if dtype == torch.float32:
        torch.testing.assert_close(E_k, E_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(C_k, C_r, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(E_r.float().abs().clamp_min(1e-30))) - 7)
        assert bool(((E_k.float() - E_r.float()).abs() <= ulp).all())
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)


XWIDE_L = [257, 288, 300, 320, 384, 512, 1000, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", XWIDE_L)
@pytest.mark.parametrize("n", [1, 63, 4099])
def test_xwide_kernel_matches_plain_version(n, L, dtype):
    """K1x, which serves L from 257 to XWIDE_MAX_L, through the dispatch at
    ragged row counts (a lone partial tile, and some blocks taking one tile
    more than others); in f32 it repeats the plain version's arithmetic bit
    for bit. The witness for that is the plain version on 4099 rows, of
    which the kernel's n are the first: cuBLAS's kernel for Q'·Mu at so many
    rows sums in the order K1x repeats, where at 1 and 63 rows it takes
    others that sum in another order."""
    _needs_card()
    assert T.XWIDE_MAX_L == 1024 and T.kernel_for(L) == "K1x"
    _check(_inputs(10, n, L), dtype)
    if dtype == torch.float32:
        padded = [torch.from_numpy(a).to("cuda") for a in _inputs(10, 4099, L)]
        rows = [a[:n] for a in padded[:3]] + padded[3:]
        E_k, C_k = T.fused_energy_update_xwide(*rows)
        E_r, C_r = T.fused_energy_update_reference(*padded)
        assert torch.equal(E_k, E_r[:n]) and torch.equal(C_k, C_r[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [257, 300, 320, 1000])
def test_xwide_kernel_takes_rows_off_16_byte_alignment(L, dtype):
    """Contiguous arrays that start one element into their storage: K1x
    stores C' value by value and tiles Mu from any alignment."""
    _needs_card()
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in _inputs(11, 1001, L)]
    shifted = []
    for a in arrays:
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
        shifted.append(buf[1:].view(a.shape).copy_(a))
    assert shifted[0].data_ptr() % 16 == shifted[0].element_size()
    _check_direct(T.fused_energy_update_xwide, shifted, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 64, 200, 256])
def test_xwide_kernel_below_its_range(L, dtype):
    """K1x launched directly at label counts K1 and K1w serve (it takes any
    L up to XWIDE_MAX_L; the dispatch sends it only those above 256)."""
    _needs_card()
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in _inputs(12, 777, L)]
    _check_direct(T.fused_energy_update_xwide, arrays, dtype)


XXWIDE_L = [1025, 1088, 1100, 1536, 2048, 4099]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", XXWIDE_L)
@pytest.mark.parametrize("n", [1, 63, 4099])
def test_xxwide_kernel_matches_plain_version(n, L, dtype):
    """K1xx, which serves every L above XWIDE_MAX_L, through the dispatch at
    ragged row counts (a lone partial tile, and work items of a few tiles);
    in f32 it repeats the plain version's arithmetic bit for bit up to 2048
    labels, where PyTorch's softmax takes its warp kernel (above it,
    PyTorch's block kernel sums in another order: F32_TOL). The witness is
    the plain version on 4099 rows, of which the kernel's n are the first,
    as for K1x (at 1 and 63 rows cuBLAS sums Q'·Mu in another order)."""
    _needs_card()
    assert T.kernel_for(L) == "K1xx"
    _check(_inputs(13, n, L), dtype)
    if dtype == torch.float32 and L <= 1536:
        padded = [torch.from_numpy(a).to("cuda") for a in _inputs(13, 4099, L)]
        rows = [a[:n] for a in padded[:3]] + padded[3:]
        E_k, C_k = T.fused_energy_update_xxwide(*rows)
        E_r, C_r = T.fused_energy_update_reference(*padded)
        assert torch.equal(E_k, E_r[:n]) and torch.equal(C_k, C_r[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1025, 1026, 1100, 1537, 4099])
def test_xxwide_kernel_takes_rows_off_16_byte_alignment(L, dtype):
    """Contiguous arrays that start one element into their storage: K1xx
    moves bf16 rows value by value (or by 8 bytes where they allow) and
    stores C' value by value, and tiles Mu from any alignment."""
    _needs_card()
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in _inputs(14, 1001, L)]
    shifted = []
    for a in arrays:
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
        shifted.append(buf[1:].view(a.shape).copy_(a))
    assert shifted[0].data_ptr() % 16 == shifted[0].element_size()
    _check_direct(T.fused_energy_update_xxwide, shifted, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 64, 300, 1024])
def test_xxwide_kernel_below_its_range(L, dtype):
    """K1xx launched directly at label counts the other kernels serve (it
    takes any L; the dispatch sends it only those above 1024)."""
    _needs_card()
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in _inputs(15, 777, L)]
    _check_direct(T.fused_energy_update_xxwide, arrays, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "last"])
def test_xxwide_bf16_rescales_where_a_later_chunk_holds_the_max(where):
    """Rows whose largest -E lies 30 log2 units above the first chunk's, in
    the last chunk: the bf16 path's online softmax rescales its sums and
    accumulators there, and still matches the plain version."""
    _needs_card()
    e0, s, c, mu = _inputs(16, 2000, 1100)
    at = 3 if where == "first" else 1099
    e0[:, at] -= 30.0 / np.log2(np.e)
    _check((e0, s, c, mu), torch.bfloat16)


# the lattice apply's kernels: widths around the teams' lanes (1, 2, 16),
# fullres128's 128, a width off the 4-value words (129), K1x's 320 and a
# width of many column passes (1536)
APPLY_L = [1, 2, 16, 128, 129, 320, 1536]


def _lattice_plan(case: str, dtype=torch.float32, n: int = 3000, d: int = 5):
    """An untiled plan built on the card from a 5-D guide whose first half
    of pixels share one value, so that each of their d+1 vertices holds more
    entries than a chunk of the splat ('hot'), or the same guide under a
    capacity below its occupancy ('overflow')."""
    rs = np.random.RandomState(20)
    ref = (rs.randn(n, d) * 1.5).astype(np.float32)
    ref[: n // 2] = 0.1
    cap = 128 if case == "overflow" else 8192
    plan = P.build_plan(torch.from_numpy(ref).to("cuda", dtype), max_vertices=cap)
    assert (int(plan.num_valid) > cap) == (case == "overflow")
    if case == "hot":
        assert int((plan.slot_start[1:] - plan.slot_start[:-1]).max()) > LK.CHUNK
    return plan


def _entry_table(plan):
    return plan.entry_order, plan.entry_weight, plan.slot_start, plan.chunk_start


def _launched(before):
    return {k: n - before[k] for k, n in LK.launch_counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("L", APPLY_L)
@pytest.mark.parametrize("case", ["hot", "overflow"])
def test_lattice_slice_kernel_is_bit_equal_to_plain(case, L, dtype):
    """The slice kernel sums the d+1 gathered rows in the plain version's
    order with separately rounded products and sums, so it is bit for bit
    the plain version on the card, row C (gathered by the overflow entries)
    included, in the promoted dtype."""
    _needs_card()
    plan = _lattice_plan(case)
    g = torch.Generator(device="cuda").manual_seed(L)
    vals = torch.randn(plan.capacity + 1, L, generator=g, device="cuda").to(dtype)
    before = LK.launch_counts()
    got = LK.lattice_slice(vals, plan.slot, plan.bary, LK.slice_scale(plan.d))
    torch.cuda.synchronize()
    assert _launched(before) == {"splat": 0, "slice": 1}
    want = LK.slice_untiled_reference(plan, vals)
    assert got.dtype == want.dtype == torch.promote_types(torch.float32, dtype)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("L", APPLY_L)
@pytest.mark.parametrize("case", ["hot", "overflow"])
def test_lattice_splat_kernel_is_within_rounding_of_float64(case, L, dtype):
    """The splat kernel against the plain version in float64. Tolerance: f32
    sums of a slot's k entries in another order (along the sorted entries,
    chunk by chunk, the partial sums of chunks that share a slot added in
    chunk order) err by at most (k+2)·2^-24 of Σ|w·x|, and the sum is
    rounded once to the output dtype (2^-8 of it in bf16); f64 sums err by
    (k+2)·2^-53 of Σ|w·x|. Row C stays zero: the overflow entries drop. The
    order is fixed, so a second launch gives the same bits."""
    _needs_card()
    plan = _lattice_plan(case)
    g = torch.Generator(device="cuda").manual_seed(L + 1)
    src = torch.randn(plan.bary.shape[0], L, generator=g, device="cuda").to(dtype)
    before = LK.launch_counts()
    got = LK.lattice_splat(src, *_entry_table(plan))
    torch.cuda.synchronize()
    assert _launched(before) == {"splat": 1, "slice": 0}
    assert got.dtype == dtype and got.shape == (plan.capacity + 1, L)
    plan64 = plan._replace(bary=plan.bary.double())
    want = LK.splat_untiled_reference(plan64, src.double())
    mag = LK.splat_untiled_reference(plan64, src.double().abs())  # Σ|w·x|: weights are ≥ 0
    k = torch.zeros(plan.capacity + 1, dtype=torch.float64, device="cuda")
    k[:-1] = (plan.slot_start[1:] - plan.slot_start[:-1]).double()
    unit = 2.0 ** -53 if dtype == torch.float64 else 2.0 ** -24
    tol = (k[:, None] + 2) * unit * mag
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
    err = (got.double() - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    assert not got[plan.capacity].any()
    again = LK.lattice_splat(src, *_entry_table(plan))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot", "overflow"])
def test_lattice_kernels_are_each_others_transpose_in_float64(case):
    """Through their autograd functions in float64, each kernel's backward
    is the other kernel: gradcheck holds, row C included (the slice's
    backward sums the overflow entries into it, the splat's backward reads
    it as the constant zero it is)."""
    _needs_card()
    plan = _lattice_plan(case, torch.float64, n=1200, d=3)
    g = torch.Generator(device="cuda").manual_seed(3)
    src = torch.randn(plan.bary.shape[0], 3, generator=g, device="cuda", dtype=torch.float64)
    vals = torch.randn(plan.capacity + 1, 3, generator=g, device="cuda", dtype=torch.float64)
    before = LK.launch_counts()
    assert torch.autograd.gradcheck(lambda x: LK.splat_untiled(plan, x),
                                    (src.requires_grad_(),), fast_mode=True)
    assert torch.autograd.gradcheck(lambda v: LK.slice_untiled(plan, v),
                                    (vals.requires_grad_(),), fast_mode=True)
    launched = _launched(before)
    assert launched["splat"] > 0 and launched["slice"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["hot", "overflow"])
def test_lattice_kernel_gradients_match_the_plain_path(case, dtype):
    """In f32 and bf16 the kernels' gradients are the plain path's (its
    autograd through the products, index_add_ and gathers, on the same
    values in f32) up to f32 sums in another order and, in bf16, one
    rounding to the input's dtype (2^-8 of it)."""
    _needs_card()
    plan = _lattice_plan(case)
    g = torch.Generator(device="cuda").manual_seed(4)
    src = torch.randn(plan.bary.shape[0], 16, generator=g, device="cuda").to(dtype)
    vals = torch.randn(plan.capacity + 1, 16, generator=g, device="cuda").to(dtype)
    for fn, ref, x in ((LK.splat_untiled, LK.splat_untiled_reference, src),
                       (LK.slice_untiled, LK.slice_untiled_reference, vals)):
        xk = x.clone().requires_grad_()
        out = fn(plan, xk)
        w = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
        (out * w).sum().backward()
        xr = x.float().requires_grad_()
        (ref(plan, xr) * w.float()).sum().backward()
        assert xk.grad.dtype == dtype
        rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
        torch.testing.assert_close(xk.grad.float(), xr.grad, rtol=rtol,
                                   atol=1e-5 * float(xr.grad.abs().max()))


@pytest.mark.cuda
def test_lattice_kernels_refuse_what_they_do_not_take():
    """A dtype the kernels do not take raises, and nothing is launched."""
    _needs_card()
    plan = _lattice_plan("hot")
    before = LK.launch_counts()
    src = torch.zeros(plan.bary.shape[0], 8, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        LK.lattice_splat(src, *_entry_table(plan))
    with pytest.raises(ValueError, match="dtype"):
        LK.lattice_slice(torch.zeros(plan.capacity + 1, 8, dtype=torch.float16, device="cuda"),
                         plan.slot, plan.bary, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        LK.lattice_slice(torch.zeros(plan.capacity + 1, 8, device="cuda"), plan.slot,
                         plan.bary.half(), 1.0)
    lean = P.build_plan(plan.bary.new_zeros(64, 5).normal_(), order_by_sum=False, tile=64,
                        tile_u=128, sort_mode="packed1")
    with pytest.raises(ValueError, match="entry table"):
        LK.splat_untiled(lean, torch.zeros(64, 100, device="cuda"))
    assert _launched(before) == {"splat": 0, "slice": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_plan_takes_the_kernels_on_the_card(dtype):
    """An untiled apply on the card launches each kernel once, runs no
    (n, d+1, L) product, `index_add_` or per-r gather in its splat and
    slice, counts itself as untiled and as run by the kernels, and agrees
    with the plain versions' apply on the card."""
    _needs_card()
    plan = _lattice_plan("hot")
    g = torch.Generator(device="cuda").manual_seed(6)
    src = torch.randn(plan.bary.shape[0], 16, generator=g, device="cuda").to(dtype)
    before = LK.launch_counts()
    profiling.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = P.apply_plan(plan, src)
        torch.cuda.synchronize()
    assert _launched(before) == {"splat": 1, "slice": 1}
    assert profiling.counter_totals() == {"lattice.apply.untiled": 1, "lattice.apply.kernel": 1}
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        vals = P._splat(plan, src)
        P._slice(plan, vals)
    ops = {e.name for e in prof.events()}
    assert not ops & {"aten::index_add_", "aten::index", "aten::mul", "aten::add"}, ops
    plain = LK.slice_untiled_reference(plan, P._blur(plan, LK.splat_untiled_reference(plan, src),
                                                     False))
    # f32 splat sums in another order; in bf16 a table value that rounds to
    # the neighbouring bf16 value moves the output by an ulp of its scale
    scale = float(plain.abs().max())
    atol = (1e-5 if dtype == torch.float32 else 2.0 ** -6) * scale
    torch.testing.assert_close(out, plain, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_untiled_apply_does_not_depend_on_how_the_plan_numbers_its_slots(dtype):
    """Two plans of one guide that number its vertices otherwise (another
    capacity, the coordinate sum as the first sort column, another sort
    mode) filter to the same bits on the card: every splat sum runs over
    its slot's own entries in their order, chunk by chunk from the slot's
    start."""
    _needs_card()
    rs = np.random.RandomState(21)
    ref = (rs.randn(3000, 5) * 1.5).astype(np.float32)
    ref[:1500] = 0.1
    ref = torch.from_numpy(ref).to("cuda")
    a = P.build_plan(ref, max_vertices=8192, order_by_sum=False)
    b = P.build_plan(ref, max_vertices=16384, order_by_sum=True, sort_mode="lex")
    assert int(a.num_valid) == int(b.num_valid) <= 8192
    assert not torch.equal(a.slot, b.slot)
    g = torch.Generator(device="cuda").manual_seed(8)
    src = torch.randn(3000, 128, generator=g, device="cuda").to(dtype)
    assert torch.equal(P.apply_plan(a, src), P.apply_plan(b, src))


# the stereo cost volume: (h, w, c, labels, window), off every tile size
# (24 columns at 32 labels, strips of 256 rows, chunks of up to 32 labels,
# runs of 8 columns); more labels than columns; a window's radius at or past
# the height (and the width), where the symmetric pad keeps reflecting; two
# strips, the second of one row (257) inside the window
COST_VOLUME_CASES = [(37, 53, 3, 16, 9), (70, 101, 3, 128, 9), (65, 25, 1, 100, 3),
                     (9, 20, 3, 100, 9), (3, 40, 3, 16, 9), (5, 3, 1, 1, 11),
                     (130, 49, 3, 320, 11), (33, 47, 1, 128, 1), (66, 97, 3, 320, 9),
                     (40, 30, 1, 16, 3), (17, 150, 3, 1, 9), (300, 41, 3, 100, 9),
                     (257, 30, 1, 16, 11)]


def _cv_pair(seed, h, w, c):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.rand(h, w, c).astype(np.float32)).to("cuda") for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 2.5])
@pytest.mark.parametrize("h,w,c,L,window", COST_VOLUME_CASES)
def test_cost_volume_kernel_matches_float64(h, w, c, L, window, scale):
    """One launch a call; within (window² c) f32 roundings of the volume's
    largest value of the float64 evaluation, as close to it as the plain
    version is plus that; the same bits twice."""
    _needs_card()
    left, right = _cv_pair(h * w + L, h, w, c)
    before = CVK.cost_volume_kernel.launches
    got = CV.cost_volume(left, right, L, window, scale=scale)
    torch.cuda.synchronize()
    assert CVK.cost_volume_kernel.launches == before + 1
    assert got.shape == (h, w, L) and got.dtype == torch.float32 and got.is_contiguous()
    exact = scale * CV.cost_volume_reference(left.double(), right.double(), L, window)
    bound = window ** 2 * c * 2.0 ** -23 * float(exact.abs().max())
    err = float((got.double() - exact).abs().max())
    assert err <= bound, (err, bound)
    plain = CV.cost_volume_reference(left, right, L, window)
    plain = plain if scale == 1 else scale * plain
    assert float((got - plain).double().abs().max()) <= bound + float(
        (plain.double() - exact).abs().max())
    assert torch.equal(got, CV.cost_volume(left, right, L, window, scale=scale))


@pytest.mark.cuda
def test_cost_volume_kernel_takes_views_made_contiguous():
    _needs_card()
    big_l, big_r = _cv_pair(5, 40, 120, 3)
    left, right = big_l[:, ::2], big_r.transpose(0, 1).contiguous().transpose(0, 1)[:, 1::2]
    assert not left.is_contiguous() and not right.is_contiguous()
    before = CVK.cost_volume_kernel.launches
    got = CV.cost_volume(left, right, 24, 9)
    assert CVK.cost_volume_kernel.launches == before + 1
    assert torch.equal(got, CVK.cost_volume_kernel(left.contiguous(), right.contiguous(), 24, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "squared", "neg_product", "zero", "even window",
                                  "requires grad"])
def test_cost_volume_kernel_leaves_other_calls_to_the_plain_version(case):
    _needs_card()
    left, right = _cv_pair(6, 21, 30, 3)
    kw = {"squared": {"criterion": CV.squared_difference},
          "neg_product": {"criterion": CV.neg_product}, "zero": {"agg_mode": "zero"}}.get(case, {})
    window = 8 if case == "even window" else 5
    if case == "float64":
        left, right = left.double(), right.double()
    if case == "requires grad":
        left.requires_grad_(True)
    before = CVK.cost_volume_kernel.launches
    got = CV.cost_volume(left, right, 12, window, scale=1.5, **kw)
    assert CVK.cost_volume_kernel.launches == before
    assert torch.equal(got, 1.5 * CV.cost_volume_reference(left, right, 12, window, **kw))
    assert got.requires_grad == (case == "requires grad")


@pytest.mark.cuda
@pytest.mark.parametrize("c,window", [(5, 5), (2, 5), (4, 9), (3, 19), (1, 21)])
def test_cost_volume_raises_for_what_the_kernel_does_not_take(c, window):
    """A call the route gives the kernel raises where the kernel is not
    built for it (channels other than 1 or 3, windows over 17): it does
    not fall back to the plain version."""
    _needs_card()
    left, right = _cv_pair(6, 21, 30, c)
    before = CVK.cost_volume_kernel.launches
    with pytest.raises(ValueError, match="takes"):
        CV.cost_volume(left, right, 12, window)
    assert CVK.cost_volume_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,L,window,labels", [
    (1088, 1920, 3, 128, 9, 32), (994, 1482, 3, 320, 9, 32), (288, 384, 3, 16, 9, 16),
    (5, 3, 1, 1, 11, 4), (64, 64, 1, 7, 17, 8), (64, 64, 3, 2, 11, 4)])
def test_cost_volume_geometry(h, w, c, L, window, labels):
    """The fewest labels a block (4 to 32, a power of two) that cover L and
    whose shared memory fits (a wider window takes more labels and so a
    narrower tile); the block's 256 threads are its haloed columns times
    its label quads."""
    _needs_card()
    g = CVK.costvolume_geometry(h, w, c, L, window)
    r = window // 2
    assert g["labels"] == labels and g["strip"] == 256 and g["smem"] <= 232448
    assert (g["tile_w"] + 2 * r) * (g["labels"] // 4) == 256
    with pytest.raises(ValueError, match="tiles"):
        CVK.costvolume_geometry(10, 16 * 65536, c, 128, 17)


@pytest.mark.cuda
def test_cost_volume_counts_its_calls_and_the_kernels():
    _needs_card()
    left, right = _cv_pair(7, 16, 24, 3)
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        CV.cost_volume(left, right, 8, 3)
        CV.cost_volume(left.double(), right.double(), 8, 3)
        CV.cost_volume(left, right, 8, 3, agg_mode="zero")
    counted = profiling.counter_totals()
    profiling.reset_counters()
    assert counted == {"costvolume.calls": 3, "costvolume.kernel": 1}
