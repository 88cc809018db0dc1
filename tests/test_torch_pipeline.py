"""End-to-end parity of the PyTorch port's stereo pipeline with the JAX
package on the CPU, at 64×96 with 8 labels.

The pair is tests/test_pallas.py's. At full contrast its calibration keeps
sort_mode 'auto', so the calibrated pipeline runs the general plan with
tiled tables; at contrast 0.5 it pins 'packed1', so it runs the lean
per-tile plan. The uncalibrated default runs the general entry-wise plan.
In float32 the disparities agree within 5e-3 px, the tolerance
tests/test_pallas.py holds the fused update to."""
from dataclasses import fields, replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models import pipeline as TP
from depth_estimation_torch.utils.weights import JAX_ONLY_FIELDS, config_from_jax
from depth_estimation_tpu.models import pipeline as JP

BASE = JP.CRFStereoConfig(num_disp=8, niters=3)


def _pair(contrast=1.0, h=64, w=96):
    left, right, _ = make_stereo_pair(np.random.RandomState(0), 64, 96, num_layers=4, max_disp=7)
    lo = 0.5 - contrast / 2
    return ((lo + contrast * left)[:h, :w].astype(np.float32),
            (lo + contrast * right)[:h, :w].astype(np.float32))


@pytest.fixture(scope="module")
def calibrated():
    """JAX calibrations, tiled with 32-px blocks, per input contrast."""
    return {c: JP.calibrate_capacity(jnp.asarray(_pair(c)[0]), BASE, tiled=True, tile_px=32)
            for c in (1.0, 0.5)}


def _run_both(pair, cfg):
    left, right = pair
    dj = np.asarray(JP.crf_stereo_infer(jnp.asarray(left), jnp.asarray(right), cfg)["disparity"])
    out = TP.crf_stereo_infer(left, right, config_from_jax(cfg), device="cpu")
    return dj, out


@pytest.mark.parametrize("contrast", [1.0, 0.5])
def test_calibration_matches_jax(calibrated, contrast):
    want = calibrated[contrast]
    got = TP.calibrate_capacity(_pair(contrast)[0], TP.CRFStereoConfig(num_disp=8, niters=3),
                                tiled=True, tile_px=32, device="cpu")
    assert got == config_from_jax(want)
    assert want.sort_mode == ("auto" if contrast == 1.0 else "packed1")


@pytest.mark.parametrize("case", ["default", "tiled", "lean", "tiled_fused", "lean_fused"])
def test_disparity_matches_jax_f32(calibrated, case):
    contrast = 0.5 if case.startswith("lean") else 1.0
    cfg = BASE if case == "default" else calibrated[contrast]
    if case.endswith("fused"):
        cfg = replace(cfg, fused_update=True)
    dj, out = _run_both(_pair(contrast), cfg)
    plan = out["plans"][0]
    assert (plan.slot is None) == case.startswith("lean")
    assert (plan.tile_A is None) == (case == "default")
    dt = out["disparity"].numpy()
    assert dt.shape == (64, 96) and np.isfinite(dt).all()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=5e-3)


def test_odd_shape_edge_pads_into_the_tiled_path(calibrated):
    """60×90 is not a multiple of the 32-px block: both packages edge-pad
    to 64×96, run the tiled plan and crop back."""
    pair = _pair(1.0, 60, 90)
    cfg = JP.calibrate_capacity(jnp.asarray(pair[0]), BASE, tiled=True, tile_px=32)
    dj, out = _run_both(pair, cfg)
    assert out["plans"][0].tile_A.shape[0] == 64 * 96 // 1024
    assert out["disparity"].shape == (60, 90)
    np.testing.assert_allclose(out["disparity"].numpy(), dj, rtol=0, atol=5e-3)


def test_dense_backend_matches_jax():
    pair = _pair(1.0, 24, 32)
    dj, out = _run_both(pair, replace(BASE, backend="dense"))
    assert out["plans"] == []
    np.testing.assert_allclose(out["disparity"].numpy(), dj, rtol=0, atol=5e-3)


def test_bench_configuration_bf16(calibrated):
    """The bench's configuration: lean plan, bf16 incidence blocks, bf16
    mean-field state and the fused update. The two packages round to bf16
    at different points (the Pallas kernel adds in bf16, the port's fused
    update in f32, and the splat sums in another order), and a label whose
    softmax is near a tie amplifies a one-ulp difference. So the bound is
    on the mean: at most 0.1 px (measured about 0.002 px)."""
    cfg = replace(calibrated[0.5], tile_bf16=True, compute_dtype="bf16", fused_update=True)
    dj, out = _run_both(_pair(0.5), cfg)
    assert out["plans"][0].slot is None
    assert out["plans"][0].tile_A.dtype == torch.bfloat16
    dt = out["disparity"].numpy()
    assert np.isfinite(dt).all()
    assert np.abs(dt - dj).mean() <= 0.1


def test_order_by_sum_never_pins_packed1():
    """The port pins 'packed1' only when the plan sorts plain lexicographic
    keys: with order_by_sum it keeps 'auto' and the general plan."""
    left, right = _pair(0.5)
    cfg = TP.calibrate_capacity(left, TP.CRFStereoConfig(num_disp=8, niters=2, order_by_sum=True),
                                tiled=True, tile_px=32, device="cpu")
    assert cfg.sort_mode == "auto"
    out = TP.crf_stereo_infer(left, right, cfg, device="cpu")
    assert out["plans"][0].slot is not None
    assert np.isfinite(out["disparity"].numpy()).all()


def test_config_from_jax_carries_every_field(calibrated):
    jcfg = replace(calibrated[0.5], tile_bf16=True, compute_dtype="bf16", fused_update=True)
    tcfg = config_from_jax(jcfg)
    kept = {k: v for k, v in jcfg.__dict__.items() if k not in JAX_ONLY_FIELDS}
    assert set(kept) == {f.name for f in fields(TP.CRFStereoConfig)}
    assert tcfg == TP.CRFStereoConfig(**kept)
    assert config_from_jax(jcfg.__dict__) == tcfg
    with pytest.raises(ValueError, match="lacks"):
        config_from_jax({"num_disp": 8, "no_such_field": 1})


def test_config_from_jax_drops_the_fields_the_port_does_not_run():
    """A JAX config calibrated with the piece splat and set to unroll: the
    port drops both fields, runs its untiled entry splat, and its disparity
    is the JAX pipeline's within 5e-3 px; any other field the port lacks
    still raises."""
    left, right = _pair(1.0)
    jcfg = replace(JP.calibrate_capacity(jnp.asarray(left), BASE, pieces=True), unroll=True)
    assert jcfg.max_pieces is not None and jcfg.tile_px is None
    dj, out = _run_both((left, right), jcfg)
    assert out["plans"][0].entry_order is not None
    dt = out["disparity"].numpy()
    assert dt.shape == (64, 96) and np.isfinite(dt).all()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=5e-3)
    with pytest.raises(ValueError, match="lacks"):
        config_from_jax({**jcfg.__dict__, "no_such_field": 1})
