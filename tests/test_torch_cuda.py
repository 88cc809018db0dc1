"""The PyTorch port's CUDA kernels (K1, K1w, K1x, K1xx and K1w_ffma)
against their plain versions, on a card.

These tests import neither JAX nor the JAX package, so a GPU machine without
JAX runs them, skipping the JAX-specific conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips (a kernel has no CPU mode)."""
import numpy as np
import pytest
import torch

from depth_estimation_torch.ops.cuda import meanfield as T


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
@pytest.mark.parametrize("L", [1, 3, 12, 24, 100, 128, 256, 300, 1025])
@pytest.mark.parametrize("n", [1, 7, 110585])
def test_wide_ffma_kernel_matches_plain_version(n, L, dtype):
    """K1w_ffma, the earlier FFMA design (on no route of the dispatch now, a
    yardstick), launched directly at the label counts it served alone
    before K1w took L up to 256, and above XWIDE_MAX_L, which it served
    before K1xx."""
    _needs_card()
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in _inputs(6, n, L)]
    before = T.fused_energy_update_wide_ffma.launches
    E_k, C_k = T.fused_energy_update_wide_ffma(*arrays)
    torch.cuda.synchronize()
    assert T.fused_energy_update_wide_ffma.launches == before + 1
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
