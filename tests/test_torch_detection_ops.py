"""The PyTorch port's detection primitives (`ops/detection.py`) and anchors
against the JAX package, in float64 on both sides (JAX with x64 on), so
that no argmax or NMS decision flips on a rounding; plus one float32 run of
the continuous parts at a stated tolerance."""
import numpy as np
import pytest
import torch

from depth_estimation_torch.models.detection import anchors as TA
from depth_estimation_torch.ops import detection as TD

F64_TOL = dict(rtol=1e-12, atol=1e-12)
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 products summed in another order


def _jd():
    from depth_estimation_tpu.ops import detection

    return detection


def _boxes(rs, n, h, w, lo=-8.0, min_wh=1.0, max_wh=30.0):
    """n random boxes, corners spilling up to 8 px over the top-left edge."""
    x1 = rs.uniform(lo, w - min_wh, n)
    y1 = rs.uniform(lo, h - min_wh, n)
    return np.stack([x1, y1, x1 + rs.uniform(min_wh, max_wh, n),
                     y1 + rs.uniform(min_wh, max_wh, n)], axis=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_box_area_and_iou_matrix():
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 17, 40, 50), _boxes(rs, 9, 40, 50)
    a[3, 2] = a[3, 0] - 2  # an inverted box has area 0
    J = _jd()
    np.testing.assert_allclose(TD.box_area(_t(a)).numpy(), np.asarray(J.box_area(jnp.asarray(a))),
                               **F64_TOL)
    np.testing.assert_allclose(TD.iou_matrix(_t(a), _t(b)).numpy(),
                               np.asarray(J.iou_matrix(jnp.asarray(a), jnp.asarray(b))), **F64_TOL)


@pytest.mark.parametrize("case", ["random", "ties", "threshold"])
def test_nms_matches_jax(case):
    import jax.numpy as jnp

    rs = np.random.RandomState(1)
    boxes = _boxes(rs, 40, 64, 64, lo=0.0, max_wh=25.0)
    scores = rs.rand(40)
    if case == "ties":
        # equal scores pick the lowest index (argmax takes the first maximum)
        scores = np.round(scores * 4) / 4
        boxes[5] = boxes[2]
    kw = dict(iou_threshold=0.5, max_outputs=30)
    if case == "threshold":
        kw.update(iou_threshold=0.3, max_outputs=50, score_threshold=0.4)
    idx_j, ok_j = _jd().nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    idx_t, ok_t = TD.nms(_t(boxes), _t(scores), **kw)
    assert idx_t.shape == (kw["max_outputs"],) and ok_t.dtype == torch.bool
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert (idx_t.numpy()[~ok_t.numpy()] == -1).all()
    if case == "threshold":
        assert not ok_t.numpy().all()  # the score threshold leaves padding


def test_roi_align_matches_jax_across_the_border():
    """Boxes straddle every edge, so samples fall in [-1, 0) and past the
    far edge: the JAX package's clipping (clip the lower tap, then +1 and
    clip, weights from the unclipped floor) is held exactly."""
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    h, w, c = 13, 17, 5
    feats = rs.randn(h, w, c)
    boxes = np.concatenate([_boxes(rs, 12, h, w, lo=-3.0, max_wh=12.0),
                            [[-1.5, -0.9, 4.0, 3.0], [w - 3.0, h - 2.5, w + 1.5, h + 0.7],
                             [-0.6, 2.0, 0.2, 2.3]]])
    for kw in (dict(output_size=(7, 7)), dict(output_size=(4, 3), spatial_scale=0.5,
                                             sampling_ratio=3)):
        want = np.asarray(jax.jit(lambda f, b: _jd().roi_align(f, b, **kw))(
            jnp.asarray(feats), jnp.asarray(boxes * (1.0 / kw.get("spatial_scale", 1.0)))))
        got = TD.roi_align(_t(feats), _t(boxes * (1.0 / kw.get("spatial_scale", 1.0))), **kw)
        np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


def test_roi_align_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    feats, boxes = rs.randn(11, 9, 3), _boxes(rs, 6, 11, 9, lo=-2.0, max_wh=8.0)
    wts = rs.randn(6, 7, 7, 3)

    def jloss(f, b):
        return jnp.sum(_jd().roi_align(f, b, (7, 7)) * wts)

    gf_j, gb_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(boxes))
    f, b = _t(feats).requires_grad_(), _t(boxes).requires_grad_()
    (TD.roi_align(f, b, (7, 7)) * _t(wts)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf_j), **F64_TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb_j), rtol=1e-10, atol=1e-10)


def test_roi_align_pyramid_matches_jax():
    import jax.numpy as jnp

    rs = np.random.RandomState(4)
    shapes = [(25, 19), (13, 10), (7, 5), (4, 3)]
    feats = [rs.randn(h, w, 6) for h, w in shapes]
    boxes = _boxes(rs, 20, 100, 76, lo=-6.0, max_wh=70.0)
    levels = rs.randint(0, 4, 20)
    want = _jd().roi_align_pyramid([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                                   jnp.asarray(levels, jnp.int32), (4, 8, 16, 32), (7, 7))
    got = TD.roi_align_pyramid([_t(f) for f in feats], _t(boxes), _t(levels), (4, 8, 16, 32),
                               (7, 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)
    # float32: the continuous part at its own tolerance
    got32 = TD.roi_align_pyramid([_t(f).float() for f in feats], _t(boxes).float(), _t(levels),
                                 (4, 8, 16, 32), (7, 7))
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), **F32_TOL)


def test_box_codecs_and_clip_match_jax():
    import jax.numpy as jnp

    rs = np.random.RandomState(5)
    a, g = _boxes(rs, 30, 64, 64, lo=0.0), _boxes(rs, 30, 64, 64, lo=0.0)
    J = _jd()
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        enc_j = np.asarray(J.encode_boxes(jnp.asarray(a), jnp.asarray(g), weights))
        enc_t = TD.encode_boxes(_t(a), _t(g), weights).numpy()
        np.testing.assert_allclose(enc_t, enc_j, **F64_TOL)
        big = enc_j * 3.0  # log-size deltas past BBOX_XFORM_CLIP
        np.testing.assert_allclose(TD.decode_boxes(_t(a), _t(big), weights).numpy(),
                                   np.asarray(J.decode_boxes(jnp.asarray(a), jnp.asarray(big),
                                                             weights)), **F64_TOL)
    assert TD.BBOX_XFORM_CLIP == J.BBOX_XFORM_CLIP
    spill = a * 1.5 - 10
    np.testing.assert_array_equal(TD.clip_boxes(_t(spill), 40, 50).numpy(),
                                  np.asarray(J.clip_boxes(jnp.asarray(spill), 40, 50)))


def test_roi_pool_max_and_roi_crop_match_jax():
    import jax.numpy as jnp

    rs = np.random.RandomState(6)
    feats, boxes = rs.randn(16, 20, 4), _boxes(rs, 9, 32, 40, lo=-4.0, max_wh=20.0)
    J = _jd()
    np.testing.assert_allclose(
        TD.roi_pool_max(_t(feats), _t(boxes), (5, 4), spatial_scale=0.5).numpy(),
        np.asarray(J.roi_pool_max(jnp.asarray(feats), jnp.asarray(boxes), (5, 4),
                                  spatial_scale=0.5)), **F64_TOL)
    np.testing.assert_allclose(
        TD.roi_crop(_t(feats), _t(boxes), (6, 6), spatial_scale=0.5).numpy(),
        np.asarray(J.roi_crop(jnp.asarray(feats), jnp.asarray(boxes), (6, 6), spatial_scale=0.5)),
        **F64_TOL)


def test_pyramid_anchors_match_jax_and_are_cached():
    from depth_estimation_tpu.models.detection.anchors import cell_anchors, pyramid_anchors

    shapes = [(25, 19), (13, 10), (7, 5), (4, 3), (2, 2)]
    args = (shapes, (4, 8, 16, 32, 64), (32, 64, 128, 256, 512))
    got = TA.pyramid_anchors(*args)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(pyramid_anchors(*args)))
    np.testing.assert_array_equal(TA.cell_anchors(48.0, (0.5, 2.0)), cell_anchors(48.0, (0.5, 2.0)))
    assert TA.pyramid_anchors(*args) is got  # built once per (shapes, device)
