"""The fused mean-field update above 256 labels (K1x): its launch geometry
and routing, its arithmetic emulated in plain torch (bf16: q as three bf16
terms with Mu streamed in k-tiles of 32 labels; f32: PyTorch's warp-softmax
order and one in-order FMA chain over the labels) against the plain
version, the plain version against the JAX package's Pallas kernel
(interpret mode) at such label counts, the wrapper's refusals, and the
calibrated fused pipeline at 320 labels against the JAX pipeline. The
kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models import pipeline as TP
from depth_estimation_torch.ops import costvolume as TC
from depth_estimation_torch.ops.cuda import meanfield as T
from depth_estimation_torch.utils.weights import config_from_jax
from depth_estimation_tpu.models import pipeline as JP
from depth_estimation_tpu.ops import costvolume as JC
from depth_estimation_tpu.ops.pallas import meanfield as J

MAX_DYNAMIC_SMEM = 232448  # what an H100 block may opt into (227 KB)
SMS = 132  # the H100's SMs
N = 1473108  # rows of a 994x1482 frame


def _inputs(seed, n, L):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, L).astype(np.float32) * 10, rs.randn(n, L).astype(np.float32),
            rs.rand(n, L).astype(np.float32), rs.rand(L, L).astype(np.float32))


# rows a tile of K1x at each L, for bf16 and f32
XWIDE_ROWS = {257: (64, 64), 320: (64, 64), 512: (32, 32), 1000: (16, 16), 1024: (16, 16)}


@pytest.mark.parametrize("L", sorted(XWIDE_ROWS))
def test_xwide_geometry(L):
    """LP is L padded to 64; a tile has the most rows (64, 32, 16) whose two
    q buffers, Mu ring and mbarriers fit a block's shared memory; one
    persistent block a SM; 8 producer and 4 consumer warps in bf16, 4 and 8
    in f32."""
    for elt, rows in zip((2, 4), XWIDE_ROWS[L]):
        g = T.xwide_geometry(N, L, elt, SMS)
        assert g.lp == -(-L // 64) * 64 and g.rows == rows
        assert g.num_tiles == -(-N // rows) and g.grid == SMS
        assert g.threads == 384
        assert g.smem_bytes == T.xwide_smem_bytes(elt, rows, g.lp) <= MAX_DYNAMIC_SMEM
        if rows < 64:  # twice the rows would not fit
            assert T.xwide_smem_bytes(elt, 2 * rows, g.lp) > MAX_DYNAMIC_SMEM
        q = rows * (g.lp + 8) * 4 if elt == 2 else g.lp * (rows + 4) * 4
        assert g.pass_cols == (160 if elt == 2 and rows == 64 else 64)
        assert g.mu_cols == -(-g.lp // g.pass_cols) * g.pass_cols >= g.lp
        assert g.smem_bytes == (2 * q + T.XWIDE_STAGES[elt] * T.xwide_stage_labels(elt, rows)
                                * g.pass_cols * elt + T.XWIDE_BARRIER_BYTES)


def test_xwide_geometry_at_its_limits():
    """A few rows launch one block; XWIDE_MAX_L (32 values a lane of a row)
    fits the smallest tile in both dtypes; above it, and on an empty input,
    it refuses."""
    g = T.xwide_geometry(5, 300, 2, SMS)
    assert (g.num_tiles, g.grid, g.rows) == (1, 1, 64)
    assert T.XWIDE_MAX_L == 1024 == 32 * 32
    for elt in (2, 4):
        assert T.xwide_geometry(1, T.XWIDE_MAX_L, elt, SMS).rows == 16
        with pytest.raises(ValueError, match="1 to 1024 labels"):
            T.xwide_geometry(1, T.XWIDE_MAX_L + 1, elt, SMS)
    with pytest.raises(ValueError, match="at least one row"):
        T.xwide_geometry(0, 320, 2, SMS)


@pytest.mark.parametrize("L,want", [(256, "K1w"), (257, "K1x"), (1024, "K1x"),
                                    (1025, "K1xx")])
def test_kernel_for_sends_257_to_xwide_max_l_to_k1x(L, want):
    assert T.kernel_for(L) == want
    assert T.kernel_for(T.XWIDE_MAX_L) == "K1x" and T.kernel_for(T.XWIDE_MAX_L + 1) == "K1xx"


def _split(q, terms):
    """q as `terms` bf16 values, each the rounding of what the ones before
    it leave (as f32)."""
    out, rest = [], q
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _xwide_bf16(E0, S, C, Mu, terms=3):
    """K1x's bf16 arithmetic in plain torch: E and the softmax in f32 (one
    division a row), C' from q's bf16 terms (smallest first) against Mu
    streamed in k-tiles of 32 labels in order (products exact in f32 since
    Mu is bf16, summed in f32), rounded once to bf16."""
    E = E0.float() + (S.float() - C.float())
    x = -E
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    q = e * (1.0 / e.sum(dim=1, keepdim=True))
    parts = _split(q, terms)[::-1]
    mu = Mu.float()
    acc = torch.zeros_like(q)
    for k0 in range(0, mu.shape[0], 32):
        k = slice(k0, k0 + 32)
        for part in parts:
            acc = acc + part[:, k] @ mu[k]
    return E.to(torch.bfloat16), acc.to(torch.bfloat16)


def _xwide_f32(E0, S, C, Mu):
    """K1x's f32 arithmetic in plain torch, the plain version's on the card:
    lane j of 32 sums exp(-E - max) over labels j, j + 32, ... below LP in
    order, the lanes' sums reduced by xor 16, 8, 4, 2, 1; q = exp / sum;
    C' summed over l in order from 0 by fused multiply-adds (each exact in
    float64, rounded to f32)."""
    n, L = E0.shape
    lp = -(-L // 64) * 64
    E = E0 + (S - C)
    x = torch.full((n, lp), float("-inf"))
    x[:, :L] = -E
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    part = torch.zeros(n, 32)
    for it in range(lp // 32):
        part = part + e[:, 32 * it:32 * it + 32]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ o]
    q = e[:, :L] / part[:, :1]
    acc = torch.zeros(n, L)
    for l in range(L):
        acc = (q[:, l:l + 1].double() * Mu[l].double() + acc.double()).float()
    return E, acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [257, 320])
def test_xwide_arithmetic_matches_plain_version(L, dtype):
    """K1x's arithmetic stays within chip_smoke.py's gates: in bf16 one bf16
    ulp on E and 1e-2 on C', moving few C' values off the plain version's
    rounding (three terms of q move fewer than two); in f32 F32_TOL, with E
    exact."""
    dtype = getattr(torch, dtype)
    n = 2048 if dtype == torch.bfloat16 else 256
    args = [torch.from_numpy(a).to(dtype) for a in _inputs(20, n, L)]
    E_r, C_r = T.fused_energy_update_reference(*args)
    if dtype == torch.bfloat16:
        E_k, C_k = _xwide_bf16(*args)
        assert torch.equal(E_k, E_r)
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)
        three = float((C_k != C_r).float().mean())
        two = float((_xwide_bf16(*args, terms=2)[1] != C_r).float().mean())
        assert three < 1e-3 and three <= two
    else:
        E_k, C_k = _xwide_f32(*args)
        assert torch.equal(E_k, E_r)
        torch.testing.assert_close(C_k, C_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [257, 320, 512])
def test_plain_version_matches_pallas_interpret_above_256(L):
    arrays = _inputs(21, 512, L)
    E_j, C_j = J.fused_energy_update(*map(jnp.asarray, arrays), block=256, interpret=True)
    E_t, C_t = T.fused_energy_update_reference(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=1e-5, atol=1e-5)


def test_xwide_wrapper_refuses_other_devices_and_dtypes():
    meta = torch.empty(16, 300, device="meta")
    with pytest.raises(ValueError, match="device"):
        T.fused_energy_update_xwide(meta, meta, meta, torch.empty(300, 300, device="meta"))
    for dtype in (torch.float16, torch.float64):
        e = torch.empty(16, 300, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="dtype"):
            T.fused_energy_update_xwide(e, e, e, torch.empty(300, 300, dtype=dtype, device="meta"))


def test_pipeline_fused_at_320_labels_matches_jax():
    """The calibrated tiled pipeline, fused, at 320 labels (the update K1x
    serves on the card) on a frame wider than L, against the JAX pipeline's
    Pallas loop in f32. At 320 labels the two packages' f32 cost volumes
    already differ by up to 1e-3 at energies of ~134, which moves the unary
    disparity by up to ~0.02 px at a few pixels; the fused mean field may
    add at most 5e-3 px to that. The witness that this gap is rounding (box
    sums taken in another order), and not a fault such as a wrong pad at
    disparities near the frame's width: in float64 the two cost volumes
    agree to 1e-9, and each package's f32 unary lies within its f32
    rounding of them."""
    left, right, _ = make_stereo_pair(np.random.RandomState(0), 32, 352, num_layers=3,
                                      max_disp=318)
    left, right = left.astype(np.float32), right.astype(np.float32)
    base = JP.CRFStereoConfig(num_disp=320, niters=3)
    cfg = replace(JP.calibrate_capacity(jnp.asarray(left), base, tiled=True, tile_px=32),
                  fused_update=True)
    oj = JP.crf_stereo_infer(jnp.asarray(left), jnp.asarray(right), cfg)
    out = TP.crf_stereo_infer(left, right, config_from_jax(cfg), device="cpu")
    assert T.kernel_for(320) == "K1x" and out["plans"][0].tile_A is not None
    np.testing.assert_allclose(out["unary"].numpy(), np.asarray(oj["unary"]), rtol=1e-5,
                               atol=2e-3)
    with jax.enable_x64(True):
        v_j = np.asarray(JC.cost_volume(jnp.asarray(left, jnp.float64),
                                        jnp.asarray(right, jnp.float64), 320, cfg.window_size))
    v_t = TC.cost_volume(torch.from_numpy(left).double(), torch.from_numpy(right).double(), 320,
                         cfg.window_size).numpy()
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-9)
    for f32 in (out["unary"].numpy(), np.asarray(oj["unary"])):
        np.testing.assert_allclose(f32, cfg.unary_scale * v_t, rtol=0, atol=1.5e-3)
    unary = np.abs(out["disparity_unary"].numpy() - np.asarray(oj["disparity_unary"]))
    dt, dj = out["disparity"].numpy(), np.asarray(oj["disparity"])
    assert dt.shape == (32, 352) and np.isfinite(dt).all()
    crf = np.abs(dt - dj)
    assert unary.max() < 0.05 and float(np.mean(unary > 5e-3)) < 0.01
    assert crf.max() <= unary.max() + 5e-3 and float(np.mean(crf > 5e-3)) <= float(
        np.mean(unary > 5e-3))
