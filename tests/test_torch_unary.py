"""Parity of the PyTorch port's unary stage, CRF inputs, oracle and helpers
with the JAX package, on the CPU. Inputs are made with numpy from a seed
and handed to both packages as float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.crf import compat as Tc
from depth_estimation_torch.crf import guides as Tg
from depth_estimation_torch.ops import boxfilter as Tb
from depth_estimation_torch.ops import costvolume as Tcv
from depth_estimation_torch.ops import dense_gaussian as Td
from depth_estimation_torch.train import metrics as Tm
from depth_estimation_torch.utils.weights import params_from_jax
from depth_estimation_tpu.crf import compat as Jc
from depth_estimation_tpu.crf import guides as Jg
from depth_estimation_tpu.ops import boxfilter as Jb
from depth_estimation_tpu.ops import costvolume as Jcv
from depth_estimation_tpu.ops import dense_gaussian as Jd
from depth_estimation_tpu.train import metrics as Jm


def _pair(seed=0, h=32, w=48):
    rs = np.random.RandomState(seed)
    return rs.rand(h, w, 3).astype(np.float32), rs.rand(h, w, 3).astype(np.float32)


@pytest.mark.parametrize("agg_mode", ["reflect", "zero"])
def test_cost_volume_matches_jax(agg_mode):
    # raw window sums of magnitude ~10²: atol 1e-3 covers f32 cumsum order
    left, right = _pair()
    want = np.asarray(Jcv.cost_volume(jnp.asarray(left), jnp.asarray(right), 8, 9,
                                      agg_mode=agg_mode))
    got = Tcv.cost_volume(torch.from_numpy(left), torch.from_numpy(right), 8, 9,
                          agg_mode=agg_mode).numpy()
    assert got.shape == want.shape == (32, 48, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_symmetric_pad_repeats_edge():
    x = torch.arange(12.0).reshape(3, 4, 1)
    want = np.pad(x.numpy(), ((2, 2), (2, 2), (0, 0)), mode="symmetric")
    np.testing.assert_array_equal(Tcv._symmetric_pad2d(x, 2).numpy(), want)


@pytest.mark.parametrize("normalize", [True, False])
def test_box_filter_matches_jax(normalize):
    x = np.random.RandomState(1).rand(20, 30, 2).astype(np.float32)
    for axis in (0, 1):
        want = np.asarray(Jb.box_filter(jnp.asarray(x), 3, axis, normalize))
        got = Tb.box_filter(torch.from_numpy(x), 3, axis, normalize).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(Jb.box_filter2d(jnp.asarray(x), 2, (0, 1), normalize))
    got = Tb.box_filter2d(torch.from_numpy(x), 2, (0, 1), normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_guides_match_jax():
    left, _ = _pair()
    want = np.asarray(jax.jit(lambda x: Jg.stack_guide(x, 0.1, 0.1))(jnp.asarray(left)))
    got = Tg.stack_guide(torch.from_numpy(left), 0.1, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Tg.pixel_coords(7, 9).numpy(),
                               np.asarray(Jg.pixel_coords(7, 9)), rtol=1e-6, atol=1e-6)
    jp = Jg.ijrgb_guide_init(0.2, 0.3)
    want = np.asarray(Jg.ijrgb_guide(jp, jnp.asarray(left)))
    got = Tg.ijrgb_guide(params_from_jax(jp, device="cpu"), torch.from_numpy(left)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_compatibility_matches_jax():
    lj = jnp.arange(16, dtype=jnp.float32)
    lt = torch.arange(16, dtype=torch.float32)
    want = np.asarray(Jc.compatibility_matrix(lambda a, b: Jc.charbonnier2(a, b, 3.0), lj))
    got = Tc.compatibility_matrix(lambda a, b: Tc.charbonnier2(a, b, 3.0), lt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(Tc.potts_matrix(5).numpy(), np.asarray(Jc.potts_matrix(5)))
    jp = Jc.charb_init(0.05)
    want = np.asarray(Jc.charb_matrix(jp, lj))
    got = Tc.charb_matrix(params_from_jax(jp, device="cpu"), lt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_decoders_and_normalization_match_jax():
    rs = np.random.RandomState(2)
    logits = (rs.randn(10, 12, 8) * 3).astype(np.float32)
    np.testing.assert_allclose(
        Tcv.expected_disparity(torch.from_numpy(logits)).numpy(),
        np.asarray(Jcv.expected_disparity(jnp.asarray(logits))), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        Tcv.disparity_estimate(torch.from_numpy(logits)).numpy(),
        np.asarray(Jcv.disparity_estimate(jnp.asarray(logits))))
    img = rs.rand(16, 20, 3).astype(np.float32)
    for window in (None, 5):
        np.testing.assert_allclose(
            Tcv.local_contrast_normalize(torch.from_numpy(img), window).numpy(),
            np.asarray(Jcv.local_contrast_normalize(jnp.asarray(img), window)),
            rtol=1e-4, atol=1e-4)


def test_dense_gaussian_matches_jax():
    rs = np.random.RandomState(3)
    ref = (rs.randn(300, 3) * 1.5).astype(np.float32)
    src = rs.rand(300, 4).astype(np.float32)
    want = np.asarray(Jd.dense_gaussian_filter(jnp.asarray(src), jnp.asarray(ref), block=64))
    got = Td.dense_gaussian_filter(torch.from_numpy(src), torch.from_numpy(ref), block=64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_metrics_match_jax():
    rs = np.random.RandomState(4)
    pred = (rs.rand(20, 30) * 8).astype(np.float32)
    gt = (rs.rand(20, 30) * 8).astype(np.float32)
    gt[:3] = 0.0
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    for tf, jf in ((Tm.epe, Jm.epe), (Tm.masked_l1, Jm.masked_l1), (Tm.masked_mse, Jm.masked_mse)):
        np.testing.assert_allclose(float(tf(tp, tg)), float(jf(jp, jg)), rtol=1e-6)
    np.testing.assert_allclose(float(Tm.bad_pixel_ratio(tp, tg, 2.0)),
                               float(Jm.bad_pixel_ratio(jp, jg, 2.0)), rtol=1e-6)
    np.testing.assert_array_equal(Tm.valid_mask(tg).numpy(), np.asarray(Jm.valid_mask(jg)))


# the cost volume's routes: on the CPU every call takes the plain version


@pytest.mark.parametrize("agg_mode,window,criterion,c", [
    ("reflect", 9, Tcv.absolute_difference, 3), ("reflect", 1, Tcv.absolute_difference, 3),
    ("reflect", 4, Tcv.absolute_difference, 3), ("reflect", 5, Tcv.squared_difference, 3),
    ("zero", 3, Tcv.absolute_difference, 3), ("reflect", 11, Tcv.neg_product, 3),
    ("reflect", 3, Tcv.absolute_difference, 1), ("reflect", 9, Tcv.absolute_difference, 5),
    ("reflect", 19, Tcv.absolute_difference, 3), ("reflect", 41, Tcv.absolute_difference, 2)])
def test_cost_volume_on_the_cpu_is_the_plain_version_bit_for_bit(agg_mode, window, criterion, c):
    """Every CPU call, shapes the card's kernel refuses included (5 or 2
    channels, windows of 19 and 41, past the frame's sides)."""
    rs = np.random.RandomState(3)
    left, right = (torch.from_numpy(rs.rand(17, 23, c).astype(np.float32)) for _ in range(2))
    got = Tcv.cost_volume(left, right, 9, window, criterion, agg_mode)
    assert torch.equal(got, Tcv.cost_volume_reference(left, right, 9, window, criterion,
                                                      agg_mode))
    scaled = Tcv.cost_volume(left, right, 9, window, criterion, agg_mode, scale=0.3)
    assert torch.equal(scaled, 0.3 * got)


def test_stereo_unary_scales_the_plain_version():
    from depth_estimation_torch.models.pipeline import CRFStereoConfig, stereo_unary

    left, right = (torch.from_numpy(a) for a in _pair(4, 19, 26))
    for scale in (1.0, 2.5, 0.1):
        cfg = CRFStereoConfig(num_disp=7, window_size=5, unary_scale=scale)
        want = scale * Tcv.cost_volume_reference(left, right, 7, 5)
        assert torch.equal(stereo_unary(left, right, cfg), want)


def test_cost_volume_counts_its_calls_and_no_kernel_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    from depth_estimation_torch.models.pipeline import CRFStereoConfig, stereo_unary
    from depth_estimation_torch.utils import profiling

    left, right = (torch.from_numpy(a) for a in _pair(5, 12, 16))
    profiling.reset_counters()
    Tcv.cost_volume(left, right, 4, 3)  # no profiler: nothing counted
    assert profiling.counter_totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        Tcv.cost_volume(left, right, 4, 3)
        stereo_unary(left, right, CRFStereoConfig(num_disp=4, window_size=3))
    counted = profiling.counter_totals()
    profiling.reset_counters()
    assert counted.get("costvolume.calls") == 2 and "costvolume.kernel" not in counted


@pytest.mark.parametrize("case", ["cpu", "float64", "2-d", "shapes differ", "even window",
                                  "no labels"])
def test_cost_volume_kernel_takes_no_cpu_tensor(case):
    """On the CPU the wrapper refuses every call, well-formed or not, before
    it builds or launches anything."""
    from depth_estimation_torch.ops.cuda import costvolume as CK

    left, right = (torch.from_numpy(a) for a in _pair(6, 8, 10))
    num_disp, window = 4, 3
    if case == "float64":
        left, right = left.double(), right.double()
    elif case == "2-d":
        left, right = left[..., 0], right[..., 0]
    elif case == "shapes differ":
        right = right[:, 1:]
    elif case == "even window":
        window = 4
    elif case == "no labels":
        num_disp = 0
    with pytest.raises(ValueError, match="CUDA images"):
        CK.cost_volume_kernel(left, right, num_disp, window)
    assert CK.cost_volume_kernel.launches == 0
