"""The fused mean-field update at every label count: the plain version
against the JAX package's Pallas kernel (interpret mode on the CPU, as
tests/test_torch_fused.py runs it) at label counts K1 does not serve, the
choice of kernel (K1x's own tests are in tests/test_torch_fused_xwide.py),
the launch geometries of K1w and K1w_ffma, K1w's
arithmetic emulated in plain torch (bf16: q split into hi + lo bf16 terms;
f32: the plain version's order of sums) against the plain version, the
wrappers' refusals, and the fused pipeline at L = 24
against the JAX pipeline. The kernels themselves are held against the
plain version on a card by tests/test_torch_cuda.py, which imports no JAX
so that a machine with a card and without JAX runs it."""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models import pipeline as TP
from depth_estimation_torch.ops.cuda import meanfield as T
from depth_estimation_torch.utils.weights import config_from_jax
from depth_estimation_tpu.models import pipeline as JP
from depth_estimation_tpu.ops.pallas import meanfield as J

MAX_DYNAMIC_SMEM = 232448  # what an H100 block may opt into (227 KB)


def _inputs(seed, n, L):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, L).astype(np.float32) * 10, rs.randn(n, L).astype(np.float32),
            rs.rand(n, L).astype(np.float32), rs.rand(L, L).astype(np.float32))


@pytest.mark.parametrize("L", [3, 12, 24, 128])
def test_plain_version_matches_pallas_interpret_at_any_L(L):
    arrays = _inputs(10, 1024, L)
    E_j, C_j = J.fused_energy_update(*map(jnp.asarray, arrays), block=512, interpret=True)
    E_t, C_t = T.fused_energy_update_reference(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,want", [(1, "K1w"), (3, "K1w"), (8, "K1"), (12, "K1w"), (16, "K1"),
                                    (24, "K1w"), (32, "K1"), (64, "K1"), (128, "K1w"),
                                    (255, "K1w"), (256, "K1w"), (257, "K1x"),
                                    (300, "K1x"), (54012, "K1w_ffma")])
def test_kernel_for_label_count(L, want):
    assert T.kernel_for(L) == want
    assert (want == "K1") == (L in T.SUPPORTED_L)
    assert (want == "K1x") == (T.WIDE_MAX_L == 256 < L <= T.XWIDE_MAX_L)
    assert (want == "K1w_ffma") == (L > T.XWIDE_MAX_L)


def test_kernel_for_refuses_no_labels():
    with pytest.raises(ValueError, match="at least one label"):
        T.kernel_for(0)


# K1w at each L on a card of 132 SMs, n = 110585, for bf16 and f32:
# (LP, output columns a block, warps a block, blocks a SM, grid_x, grid_y,
# dynamic shared memory)
WIDE = {1: ((32, 32, 8, 2, 264, 1, 26624), (32, 32, 8, 2, 264, 1, 16384)),
        3: ((32, 32, 8, 2, 264, 1, 26624), (32, 32, 8, 2, 264, 1, 16384)),
        8: ((32, 32, 8, 2, 264, 1, 26624), (32, 32, 8, 2, 264, 1, 16384)),
        12: ((32, 32, 8, 2, 264, 1, 26624), (32, 32, 8, 2, 264, 1, 16384)),
        16: ((32, 32, 8, 2, 264, 1, 26624), (32, 32, 8, 2, 264, 1, 16384)),
        24: ((32, 32, 8, 2, 264, 1, 26624), (32, 32, 8, 2, 264, 1, 16384)),
        32: ((32, 32, 8, 2, 264, 1, 26624), (32, 32, 8, 2, 264, 1, 16384)),
        64: ((64, 64, 8, 2, 264, 1, 61440), (64, 64, 16, 1, 132, 1, 65536)),
        128: ((128, 128, 12, 1, 132, 1, 188416), (128, 128, 20, 1, 132, 1, 188416)),
        256: ((256, 256, 3, 1, 132, 1, 221184), (256, 128, 8, 1, 132, 2, 229376))}


@pytest.mark.parametrize("L", sorted(WIDE))
def test_wide_geometry(L):
    """LP is the power of two ≥ max(L, 32); a block's column blocks cover
    LP; the persistent blocks fill the SMs' slots; the shared memory is Mu
    and a staging buffer a warp (and in f32 a q tile), within the card's."""
    n = 110585
    for elt, want in zip((2, 4), WIDE[L]):
        g = T.wide_geometry(n, L, elt, 132)
        assert (g.lp, g.nb, g.warps, g.min_blocks, g.grid_x, g.grid_y, g.smem_bytes) == want
        assert g.lp >= max(L, 32) and g.lp & (g.lp - 1) == 0 and g.lp < 2 * max(L, 32)
        assert g.rows == (16 if elt == 2 else 8)  # bf16: one MMA row tile
        assert g.num_tiles == -(-n // g.rows) and g.grid_y * g.nb == g.lp
        assert g.grid_x == min(132 * g.min_blocks, -(-g.num_tiles // g.warps))
        cfg = T.wide_config(elt, g.lp)
        if elt == 2:  # Mu transposed, a staging buffer a warp
            assert g.smem_bytes == g.nb * cfg["stride"] * 2 + g.warps * 3 * g.rows * g.lp * 2
        else:  # Mu, a q tile a warp
            assert g.smem_bytes == g.lp * g.nb * 4 + g.warps * g.lp * T.WIDE_Q_STRIDE * 4
        assert g.smem_bytes * g.min_blocks <= MAX_DYNAMIC_SMEM


def test_wide_geometry_at_its_limits():
    """A few rows launch one block; above WIDE_MAX_L it refuses (K1w_ffma's
    labels), as it does an empty input."""
    g = T.wide_geometry(5, 200, 4, 132)
    assert (g.num_tiles, g.grid_x, g.grid_y) == (1, 1, 2)
    assert T.wide_geometry(1, 256, 2, 132).lp == 256
    with pytest.raises(ValueError, match="1 to 256 labels"):
        T.wide_geometry(1, 257, 2, 132)
    with pytest.raises(ValueError, match="at least one row"):
        T.wide_geometry(0, 24, 2, 132)


# (tile_rows, q_stride, col_chunk, smem_bytes) of K1w_ffma at each L
WIDE_FFMA = {1: (1024, 8, 4, 33792), 3: (1024, 8, 4, 33792), 8: (512, 12, 8, 26624),
             12: (256, 16, 16, 20480), 16: (256, 20, 16, 24576), 24: (128, 28, 32, 22528),
             32: (128, 36, 32, 26624), 64: (64, 68, 64, 33792), 128: (64, 132, 64, 50176),
             256: (64, 260, 64, 82944)}


@pytest.mark.parametrize("L", sorted(WIDE_FFMA))
def test_wide_ffma_geometry(L):
    """Tiles cover every row once; a tile's q rows hold L floats in whole
    float4s; each thread carries at most 4 rows of 4 columns; the shared
    memory is the q tile and one 64-row block of Mu, within the card's."""
    n = 110585
    g = T.wide_ffma_geometry(n, L)
    assert (g.tile_rows, g.q_stride, g.col_chunk, g.smem_bytes) == WIDE_FFMA[L]
    assert g.num_tiles == -(-n // g.tile_rows)
    assert (g.num_tiles - 1) * g.tile_rows < n <= g.num_tiles * g.tile_rows
    assert g.q_stride % 4 == 0 and g.q_stride >= L + 4
    assert g.col_chunk >= min(L, 64) and g.col_chunk & (g.col_chunk - 1) == 0
    threads_a_row_group = g.col_chunk // 4
    assert g.tile_rows <= T.WIDE_FFMA_THREADS // threads_a_row_group * T.WIDE_FFMA_ROWS_PER_THREAD
    assert g.smem_bytes == (g.tile_rows * g.q_stride + T.WIDE_FFMA_MU_ROWS * g.col_chunk) * 4
    assert g.smem_bytes <= MAX_DYNAMIC_SMEM


def test_wide_ffma_geometry_at_its_limits():
    """One row a tile where q is large; over the card's shared memory it
    refuses, as it does an empty input."""
    g = T.wide_ffma_geometry(5, 20000)
    assert g.tile_rows == 1 and g.num_tiles == 5 and g.smem_bytes <= MAX_DYNAMIC_SMEM
    assert T.wide_ffma_geometry(1, 54012).smem_bytes == MAX_DYNAMIC_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        T.wide_ffma_geometry(1, 54013)
    with pytest.raises(ValueError, match="at least one row"):
        T.wide_ffma_geometry(0, 24)


def _bf16_update(E0, S, C, Mu, split=True):
    """K1w's bf16 arithmetic in plain torch: E and the softmax in f32, then
    C' from q as the kernel's two bf16 terms (q_lo·Mu + q_hi·Mu; products
    exact in f32 since Mu is bf16, summed in f32) or, with split=False, a q
    rounded once to bf16; rounded once to bf16."""
    E = E0.float() + (S.float() - C.float())
    q, mu = torch.softmax(-E, dim=-1), Mu.float()
    hi = q.to(torch.bfloat16).float()
    Cn = (q - hi).to(torch.bfloat16).float() @ mu + hi @ mu if split else hi @ mu
    return E.to(torch.bfloat16), Cn.to(torch.bfloat16)


def _f32_update(E0, S, C, Mu):
    """K1w's f32 arithmetic in plain torch, the plain version's on the card:
    a row's softmax over 32 lanes, lane j summing labels j, j + 32, ... in
    order, the lanes' sums reduced by xor 16, 8, 4, 2, 1 (PyTorch's warp
    softmax), then C' summed over l in order by fused multiply-adds (each
    exact in float64, rounded to f32)."""
    n, L = E0.shape
    E = E0 + (S - C)
    width = 32 * max(1, 1 << (L - 1).bit_length() >> 5)
    x = torch.full((n, width), float("-inf"))
    x[:, :L] = -E
    m = x.max(dim=1, keepdim=True).values
    e = torch.exp(x - m)
    part = torch.zeros(n, 32)
    for it in range(width // 32):
        part = part + e[:, 32 * it:32 * it + 32]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ o]
    q = e[:, :L] / part[:, :1]
    acc = torch.zeros(n, L)
    for l in range(L):
        acc = (q[:, l:l + 1].double() * Mu[l].double() + acc.double()).float()
    return E, acc


def _kernel_inputs(n, L, dtype, seed=0):
    """chip_smoke.py's `kernel_inputs` distribution, made with numpy."""
    return [torch.from_numpy(a).to(dtype) for a in _inputs(seed, n, L)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [24, 128, 256])
def test_kernel_arithmetic_matches_plain_version(L, dtype):
    """K1w's arithmetic stays within chip_smoke.py's gates: in bf16 (q's
    bf16 hi and lo against an exact bf16 Mu, on the tensor cores) one bf16
    ulp on E and 1e-2 on C', moving few C' values off the plain version's
    rounding; in f32 (the plain version's order of sums, on the FFMA pipes)
    F32_TOL, with E exact."""
    dtype = getattr(torch, dtype)
    args = _kernel_inputs(4096, L, dtype)
    E_r, C_r = T.fused_energy_update_reference(*args)
    if dtype == torch.bfloat16:
        E_k, C_k = _bf16_update(*args)
        assert torch.equal(E_k, E_r)
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)
        assert float((C_k != C_r).float().mean()) < 1e-3
    else:
        E_k, C_k = _f32_update(*args)
        assert torch.equal(E_k, E_r)
        torch.testing.assert_close(C_k, C_r, rtol=1e-5, atol=1e-5)


def test_bf16_split_moves_fewer_values_than_one_rounding():
    """A q rounded once to bf16 moves several percent of C' values off the
    plain version's bf16 rounding at 128 labels; the hi + lo split moves
    under a thousandth (so the test above can tell them apart)."""
    args = _kernel_inputs(4096, 128, torch.bfloat16)
    _, C_r = T.fused_energy_update_reference(*args)
    once = float((_bf16_update(*args, split=False)[1] != C_r).float().mean())
    split = float((_bf16_update(*args)[1] != C_r).float().mean())
    assert once > 0.03 and split < 1e-3 and once > 50 * split


def test_wrappers_take_the_plain_version_on_the_cpu_uncounted():
    arrays = [torch.from_numpy(a) for a in _inputs(11, 300, 24)]
    wrappers = (T.fused_energy_update, T.fused_energy_update_wide, T.fused_energy_update_wide_ffma)
    counts = [fn.launches for fn in wrappers]
    E_r, C_r = T.fused_energy_update_reference(*arrays)
    for fn in wrappers:
        E, C = fn(*arrays)
        assert torch.equal(E, E_r) and torch.equal(C, C_r)
    assert [fn.launches for fn in wrappers] == counts


@pytest.mark.parametrize("fn", ["fused_energy_update", "fused_energy_update_wide",
                                "fused_energy_update_wide_ffma"])
def test_wrappers_refuse_other_devices_and_dtypes(fn):
    fn = getattr(T, fn)
    meta = torch.empty(16, 24, device="meta")
    with pytest.raises(ValueError, match="device"):
        fn(meta, meta, meta, torch.empty(24, 24, device="meta"))
    for dtype in (torch.float16, torch.float64):
        e = torch.empty(16, 24, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="dtype"):
            fn(e, e, e, torch.empty(24, 24, dtype=dtype, device="meta"))


def test_pipeline_fused_at_24_labels_matches_jax():
    """The calibrated tiled pipeline, fused, at a label count that only K1w
    serves on the card, against the JAX pipeline's Pallas loop in f32."""
    left, right, _ = make_stereo_pair(np.random.RandomState(0), 64, 96, num_layers=4,
                                      max_disp=20)
    left, right = left.astype(np.float32), right.astype(np.float32)
    base = JP.CRFStereoConfig(num_disp=24, niters=3)
    cfg = replace(JP.calibrate_capacity(jnp.asarray(left), base, tiled=True, tile_px=32),
                  fused_update=True)
    dj = np.asarray(JP.crf_stereo_infer(jnp.asarray(left), jnp.asarray(right), cfg)["disparity"])
    out = TP.crf_stereo_infer(left, right, config_from_jax(cfg), device="cpu")
    dt = out["disparity"].numpy()
    assert out["plans"][0].tile_A is not None
    assert dt.shape == (64, 96) and np.isfinite(dt).all()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=5e-3)

