"""The PyTorch port's detection model against the JAX package: the ResNet-FPN
pyramid at an odd size, `MaskRCNN` inference with the keypoint branch and
every output key, the training-mode forward with GT appended, per-class
detections and test-time augmentation.

The flax parameters are carried across by `load_jax_params`. Parity runs in
float64 on both sides (JAX with x64 on, the flax params cast), so that no
argsort or NMS decision flips on a rounding; one float32 run holds the
continuous stages (pyramid, RPN head, box and mask heads on given
proposals) at a stated tolerance."""
import numpy as np
import pytest
import torch

from depth_estimation_torch.models.detection.backbone import ResNetFPN
from depth_estimation_torch.models.detection.rcnn import MaskRCNN, perclass_detections
from depth_estimation_torch.models.detection.tta import detect_augmented, hflip_boxes
from depth_estimation_torch.utils.weights import load_jax_params

KW = dict(num_classes=4, blocks=(1, 1, 1, 1), fpn_dim=32, num_proposals=16, num_detections=8,
          score_thresh=-1.0, num_keypoints=5)
F64_TOL = dict(rtol=1e-9, atol=1e-9)
# float32 port against the float64 JAX run: through 20 conv+GN layers the
# float32 roundings stay under this, relative to each output's scale
F32_RTOL = 2e-4
# keypoint coordinates: the JAX package divides the float32 bin centre by m,
# which XLA rewrites into a product with 1/m
KP_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small float64 runs gain little from
    more (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# an odd size: levels 25×19, 13×10, 7×5, 4×3, 2×2, where the FPN's top-down
# upsampling needs half-pixel nearest (`nearest-exact`)
H, W = 100, 76


def _image(h=H, w=W, seed=0):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model with its float64 params and its jitted outputs on
    the test image: inference, and training with two GT boxes."""
    import jax
    import jax.numpy as jnp

    from depth_estimation_tpu.models.detection.backbone import ResNetFPN as JResNetFPN
    from depth_estimation_tpu.models.detection.rcnn import MaskRCNN as JMaskRCNN

    model = JMaskRCNN(**KW)
    img = jnp.asarray(_image())
    gt_boxes = jnp.asarray([[8, 8, 24, 24], [30, 30, 50, 50]], jnp.float32)
    gt_valid = jnp.asarray([True, False])
    params = _f64(model.init(jax.random.PRNGKey(0), img))
    infer_fn = jax.jit(lambda p, im: model.apply(p, im))
    infer = infer_fn(params, img)
    train = jax.jit(lambda p, im: model.apply(p, im, train=True, gt_boxes=gt_boxes,
                                              gt_valid=gt_valid))(params, img)
    pyramid = jax.jit(JResNetFPN(KW["blocks"], KW["fpn_dim"]).apply)(
        {"params": params["params"]["ResNetFPN_0"]}, img[None])
    return {"model": model, "params": params, "infer_fn": infer_fn, "infer": infer, "train": train,
            "pyramid": pyramid, "gt": (np.asarray(gt_boxes), np.asarray(gt_valid))}


@pytest.fixture(scope="module")
def port(jax_model):
    m = MaskRCNN(**KW, device="cpu").double()
    return load_jax_params(m, jax_model["params"], device="cpu")


def _close(got, want, key, **tol):
    assert got is not None, key
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=key,
                               **(tol or F64_TOL))


def test_resnet_fpn_pyramid_at_an_odd_size(jax_model):
    tm = load_jax_params(ResNetFPN(blocks=(1, 1, 1, 1), out_dim=32).double(),
                         {"params": jax_model["params"]["params"]["ResNetFPN_0"]}, device="cpu")
    with torch.no_grad():
        got = tm(torch.from_numpy(_image()).double().permute(2, 0, 1)[None])
    assert [tuple(g.shape[-2:]) for g in got] == [(25, 19), (13, 10), (7, 5), (4, 3), (2, 2)]
    for g, w in zip(got, jax_model["pyramid"]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **F64_TOL)


def test_maskrcnn_inference_matches_jax(jax_model, port):
    want = jax_model["infer"]
    with torch.no_grad():
        got = port(torch.from_numpy(_image()))
    assert set(got) == set(want)
    for key in want:
        tol = dict(rtol=0, atol=KP_ATOL) if key == "keypoints" else F64_TOL
        _close(got[key], want[key], key, **tol)
    assert got["masks"].shape == (8, 28, 28) and got["kp_logits"].shape == (8, 56, 56, 5)
    assert got["classes"].dtype == torch.int64 and got["valid"].dtype == torch.bool


def test_maskrcnn_training_forward_appends_gt(jax_model, port):
    want = jax_model["train"]
    gt_boxes, gt_valid = (torch.from_numpy(a.copy()) for a in jax_model["gt"])
    with torch.no_grad():
        got = port(torch.from_numpy(_image()), train=True, gt_boxes=gt_boxes, gt_valid=gt_valid)
    assert set(got) == set(want) and got["masks"] is None
    for key in want:
        if want[key] is not None:
            _close(got[key], want[key], key)
    np.testing.assert_array_equal(got["proposals"][-2:].numpy(), jax_model["gt"][0])
    assert got["mask_logits"].shape[0] == KW["num_proposals"]


def test_float32_stages_match_the_float64_reference(jax_model):
    """The port in float32 against JAX in float64: pyramid, RPN head, and
    the box, mask and keypoint heads on the JAX run's proposals."""
    m = load_jax_params(MaskRCNN(**KW, device="cpu"), jax_model["params"], device="cpu")
    img = _image()
    jfeats = jax_model["pyramid"]

    def rel(a, b):
        a, b = a.detach().double().numpy(), np.asarray(b, np.float64)
        return np.abs(a - b).max() / np.abs(b).max()

    with torch.no_grad():
        feats = m.features(torch.from_numpy(img))
        for f, w in zip(feats, jfeats):
            assert rel(f.permute(0, 2, 3, 1), w) < F32_RTOL
        rpn = m.rpn(feats, H, W)
        want = jax_model["train"]
        for k in ("rpn_logits", "rpn_deltas"):
            assert rel(rpn[k], want[k]) < F32_RTOL, k
        props = torch.from_numpy(np.asarray(want["proposals"], np.float32))
        roi = m.roi_heads(feats, props, torch.from_numpy(np.array(want["proposal_valid"])),
                          H, W, train=True)
    for k in ("cls_scores", "cls_deltas", "mask_logits", "kp_logits"):
        assert rel(roi[k], want[k]) < F32_RTOL, k


def test_perclass_detections_keep_two_classes_on_one_box():
    """Two classes on one proposal both survive the class-aware NMS."""
    probs = np.full((4, 4), 1e-4)
    probs[0, 1], probs[1, 2], probs[2, 0] = 0.9, 0.8, 0.99
    proposals = torch.tensor([[10, 10, 30, 30], [11, 11, 31, 31], [40, 40, 50, 50], [0, 0, 5, 5]],
                             dtype=torch.float64)
    boxes, cls, scores, ok = perclass_detections(
        torch.from_numpy(probs), torch.zeros(4, 4, 4, dtype=torch.float64), proposals,
        torch.tensor([True, True, True, False]), 64, 64, 8)
    got = sorted((int(c), round(float(s), 3)) for c, s, o in zip(cls, scores, ok) if o)
    assert (1, 0.9) in got and (2, 0.8) in got


def test_detect_augmented_matches_jax(jax_model, port):
    """hflip and one scale view (0.75: a shrink, where antialiased bilinear
    matches `jax.image.resize(..., 'linear')`), merged by class-aware NMS."""
    import jax.numpy as jnp

    from depth_estimation_tpu.models.detection.tta import detect_augmented as j_detect_augmented
    from depth_estimation_tpu.models.detection.tta import hflip_boxes as j_hflip

    img = _image(seed=2).astype(np.float64)
    infer = jax_model["infer_fn"]
    want = j_detect_augmented(jax_model["model"], jax_model["params"], jnp.asarray(img),
                              hflip=True, scales=(0.75,), infer_fn=infer)
    got = detect_augmented(port, torch.from_numpy(img), hflip=True, scales=(0.75,))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], key)
    b = np.random.RandomState(3).rand(5, 4) * 30
    np.testing.assert_array_equal(hflip_boxes(torch.from_numpy(b), 64).numpy(),
                                  np.asarray(j_hflip(jnp.asarray(b), 64)))
