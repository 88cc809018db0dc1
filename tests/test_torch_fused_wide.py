"""The fused mean-field update at every label count: the plain version
against the JAX package's Pallas kernel (interpret mode on the CPU, as
tests/test_torch_fused.py runs it) at label counts K1 does not serve, the
choice of kernel, K1w's launch geometry, the wrapper's refusals, and the
fused pipeline at L = 24 against the JAX pipeline. K1w itself is held
against the plain version on a card by tests/test_torch_cuda.py, which
imports no JAX so that a machine with a card and without JAX runs it."""
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
                                    (256, "K1w")])
def test_kernel_for_label_count(L, want):
    assert T.kernel_for(L) == want
    assert (want == "K1") == (L in T.SUPPORTED_L)


def test_kernel_for_refuses_no_labels():
    with pytest.raises(ValueError, match="at least one label"):
        T.kernel_for(0)


# (tile_rows, q_stride, col_chunk, smem_bytes) of K1w at each L
WIDE = {1: (1024, 8, 4, 33792), 3: (1024, 8, 4, 33792), 8: (512, 12, 8, 26624),
        12: (256, 16, 16, 20480), 16: (256, 20, 16, 24576), 24: (128, 28, 32, 22528),
        32: (128, 36, 32, 26624), 64: (64, 68, 64, 33792), 128: (64, 132, 64, 50176),
        256: (64, 260, 64, 82944)}


@pytest.mark.parametrize("L", sorted(WIDE))
def test_wide_geometry(L):
    """Tiles cover every row once; a tile's q rows hold L floats in whole
    float4s; each thread carries at most 4 rows of 4 columns; the shared
    memory is the q tile and one 64-row block of Mu, within the card's."""
    n = 110585
    g = T.wide_geometry(n, L)
    assert (g.tile_rows, g.q_stride, g.col_chunk, g.smem_bytes) == WIDE[L]
    assert g.num_tiles == -(-n // g.tile_rows)
    assert (g.num_tiles - 1) * g.tile_rows < n <= g.num_tiles * g.tile_rows
    assert g.q_stride % 4 == 0 and g.q_stride >= L + 4
    assert g.col_chunk >= min(L, 64) and g.col_chunk & (g.col_chunk - 1) == 0
    threads_a_row_group = g.col_chunk // 4
    assert g.tile_rows <= T.WIDE_THREADS // threads_a_row_group * T.WIDE_ROWS_PER_THREAD
    assert g.smem_bytes == (g.tile_rows * g.q_stride + T.WIDE_MU_ROWS * g.col_chunk) * 4
    assert g.smem_bytes <= MAX_DYNAMIC_SMEM


def test_wide_geometry_at_its_limits():
    """One row a tile where q is large; over the card's shared memory it
    refuses, as it does an empty input."""
    g = T.wide_geometry(5, 20000)
    assert g.tile_rows == 1 and g.num_tiles == 5 and g.smem_bytes <= MAX_DYNAMIC_SMEM
    assert T.wide_geometry(1, 54012).smem_bytes == MAX_DYNAMIC_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        T.wide_geometry(1, 54013)
    with pytest.raises(ValueError, match="at least one row"):
        T.wide_geometry(0, 24)


def test_wrappers_take_the_plain_version_on_the_cpu_uncounted():
    arrays = [torch.from_numpy(a) for a in _inputs(11, 300, 24)]
    counts = T.fused_energy_update.launches, T.fused_energy_update_wide.launches
    E_r, C_r = T.fused_energy_update_reference(*arrays)
    for fn in (T.fused_energy_update, T.fused_energy_update_wide):
        E, C = fn(*arrays)
        assert torch.equal(E, E_r) and torch.equal(C, C_r)
    assert (T.fused_energy_update.launches, T.fused_energy_update_wide.launches) == counts


@pytest.mark.parametrize("fn", ["fused_energy_update", "fused_energy_update_wide"])
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

