"""The PyTorch port's detection losses and its single-device training step
against the JAX package, in float64 on both sides: the five losses and the
keypoint loss with their targets, one `train_detection_items` Adam step
(loss, parts and parameters against `optax.adam`), the optax gradient clip
and the frozen backbone."""
import numpy as np
import pytest
import torch

from depth_estimation_torch.models.detection import losses as TL
from depth_estimation_torch.models.detection.rcnn import MaskRCNN, keypoint_loss
from depth_estimation_torch.train import experiments as TE
from depth_estimation_torch.utils.weights import state_dict_from_jax

F64_TOL = dict(rtol=1e-10, atol=1e-10)
# the RPN box targets are encoded in float32 in both packages (float32
# anchors and GT boxes), and their log rounds per library
RPN_TOL = dict(rtol=1e-7, atol=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small float64 runs gain little from
    more (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed=0, A=60, R=12, G=3, h=48, w=48):
    rs = np.random.RandomState(seed)

    def boxes(n, lo=4.0, size=(6.0, 20.0)):
        x1, y1 = rs.uniform(lo, w - 24, n), rs.uniform(lo, h - 24, n)
        return np.stack([x1, y1, x1 + rs.uniform(*size, n), y1 + rs.uniform(*size, n)], 1)

    gt = boxes(G).astype(np.float32)
    anchors = np.concatenate([boxes(A - G), gt + rs.uniform(-1, 1, gt.shape)]).astype(np.float32)
    proposals = np.concatenate([boxes(R - G), gt + rs.uniform(-2, 2, gt.shape)])
    masks = np.zeros((G, h, w), np.float32)
    for g, (x1, y1, x2, y2) in enumerate(gt.astype(int)):
        masks[g, y1:y2, x1:x2] = 1.0
    return {"gt": gt, "valid": np.array([True] * (G - 1) + [False]), "classes": np.arange(1, G + 1),
            "anchors": anchors, "proposals": proposals, "prop_valid": rs.rand(R) > 0.2,
            "rpn_logits": rs.randn(A), "rpn_deltas": rs.randn(A, 4) * 0.3,
            "cls_scores": rs.randn(R, 5), "cls_deltas": rs.randn(R, 5, 4) * 0.3,
            "mask_logits": rs.randn(R, 14, 14, 5), "masks": masks,
            "kps": (gt[:, None, :2] + rs.uniform(0, 6, (G, 3, 2))).astype(np.float32),
            "kp_vis": rs.rand(G, 3) > 0.3, "kp_logits": rs.randn(R, 8, 8, 3)}


def test_losses_and_targets_match_jax():
    import jax.numpy as jnp

    from depth_estimation_tpu.models.detection import losses as JL
    from depth_estimation_tpu.models.detection.rcnn import keypoint_loss as j_keypoint_loss

    s = _scene()
    J = {k: jnp.asarray(v) for k, v in s.items()}
    T = {k: _t(v) for k, v in s.items()}
    x = np.linspace(-0.5, 0.5, 11)
    np.testing.assert_allclose(TL.smooth_l1(_t(x)).numpy(), np.asarray(JL.smooth_l1(x)), **F64_TOL)

    labels_j, matched_j = JL.match_anchors(J["anchors"], J["gt"], J["valid"])
    labels_t, matched_t = TL.match_anchors(T["anchors"], T["gt"], T["valid"])
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    np.testing.assert_array_equal(matched_t.numpy(), np.asarray(matched_j))
    assert (labels_t == 1).any() and (labels_t == 0).any() and (labels_t == -1).any()

    want = JL.rpn_losses(J["rpn_logits"], J["rpn_deltas"], J["anchors"], J["gt"], J["valid"])
    got = TL.rpn_losses(T["rpn_logits"], T["rpn_deltas"], T["anchors"], T["gt"], T["valid"])
    for g, w, tol in zip(got, want, (F64_TOL, RPN_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)

    want = JL.roi_losses(J["cls_scores"], J["cls_deltas"], J["proposals"], J["prop_valid"],
                         J["gt"], J["classes"], J["valid"])
    got = TL.roi_losses(T["cls_scores"], T["cls_deltas"], T["proposals"], T["prop_valid"],
                        T["gt"], T["classes"], T["valid"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64_TOL)
    _, _, tgt_cls, best_gt, fg = got
    assert fg.any()

    tm_j = JL.roi_mask_targets(J["masks"], jnp.asarray(best_gt.numpy()), J["proposals"], (14, 14))
    tm_t = TL.roi_mask_targets(T["masks"], best_gt, T["proposals"], (14, 14))
    np.testing.assert_array_equal(tm_t.numpy(), np.asarray(tm_j))
    np.testing.assert_allclose(
        TL.mask_loss(T["mask_logits"], tgt_cls, tm_t, fg).numpy(),
        np.asarray(JL.mask_loss(J["mask_logits"], jnp.asarray(tgt_cls.numpy()), tm_j,
                                jnp.asarray(fg.numpy()))), **F64_TOL)

    xy_j, vis_j = JL.keypoint_targets(J["kps"], J["kp_vis"], jnp.asarray(best_gt.numpy()),
                                      J["proposals"], heatmap_size=8)
    xy_t, vis_t = TL.keypoint_targets(T["kps"], T["kp_vis"], best_gt, T["proposals"],
                                      heatmap_size=8)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    np.testing.assert_allclose(
        keypoint_loss(T["kp_logits"], xy_t, vis_t, fg).numpy(),
        np.asarray(j_keypoint_loss(J["kp_logits"], xy_j, vis_j, jnp.asarray(fg.numpy()))),
        **F64_TOL)


def test_match_anchors_forces_the_best_anchor_of_valid_gts_only():
    """Padded GTs (all IoU -1) have best anchor 0 too: anchor 0 is positive
    only when a valid GT picks it, and keeps its own label otherwise."""
    anchors = _t([[0.0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]])
    gt = _t([[0.0, 0, 9, 9], [41, 41, 50, 50], [0, 0, 1, 1], [0, 0, 1, 1]])
    for valid, want0 in (([True, True, False, False], 1), ([False, True, False, False], 0)):
        labels, _ = TL.match_anchors(anchors, gt, _t(valid))
        assert labels.tolist() == [want0, 0, 1], (valid, labels)


@pytest.fixture(scope="module")
def one_step():
    """One Adam step of `train_detection_items` in both packages from the
    same flax init (keypoint branch on, grad_clip 1.0, so the clip binds)."""
    import jax
    import jax.numpy as jnp

    from depth_estimation_tpu.data.shapes import NUM_CLASSES, ShapesDetection
    from depth_estimation_tpu.models.detection.rcnn import MaskRCNN as JMaskRCNN
    from depth_estimation_tpu.train import experiments as JE

    ds = ShapesDetection(num_items=2, h=64, w=64, max_shapes=2, seed=0)
    items = [ds.padded(i) for i in range(2)]
    kw = dict(num_classes=NUM_CLASSES, blocks=(1, 1, 1, 1), fpn_dim=32, num_proposals=32,
              num_detections=8, score_thresh=-1.0, num_keypoints=5)
    jm = JMaskRCNN(**kw)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64), jm.init(
        jax.random.PRNGKey(0), jnp.asarray(items[0]["image"], jnp.float32), train=True))
    common = dict(num_steps=1, loss_breakdown=True, with_keypoints=True, grad_clip=1.0)
    jp, jh = JE.train_detection_items(items, NUM_CLASSES, init_params=p0, **common)
    template = MaskRCNN(**kw, device="cpu").double()
    model, th = TE.train_detection_items(items, NUM_CLASSES, init_params=state_dict_from_jax(
        template, p0), device="cpu", **common)
    return {"jax": (state_dict_from_jax(template, jp), jh), "port": (model, th),
            "p0": state_dict_from_jax(template, p0), "items": items}


def test_train_step_matches_optax(one_step):
    want_sd, jh = one_step["jax"]
    model, th = one_step["port"]
    np.testing.assert_allclose(th["loss"], jh["loss"], **RPN_TOL)
    assert set(th["parts"][0]) == set(jh["parts"][0]) == {
        "rpn_cls", "rpn_reg", "roi_cls", "roi_reg", "mask", "keypoint"}
    for k, v in jh["parts"][0].items():
        np.testing.assert_allclose(th["parts"][0][k], v, err_msg=k,
                                   **(RPN_TOL if k == "rpn_reg" else F64_TOL))
    moved = 0
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-9, atol=1e-9, err_msg=k)
        moved += int(not torch.equal(v, one_step["p0"][k]))
    assert moved == len(want_sd)  # every parameter took a step
    for k in ("map50", "mask_iou", "kp_ap50"):
        assert th[k] == jh[k], k


def test_grad_clip_matches_optax():
    import jax.numpy as jnp
    import optax

    rs = np.random.RandomState(7)
    grads = [rs.randn(3, 4), rs.randn(5), rs.randn(2, 2, 2)]
    norm = np.sqrt(sum((g ** 2).sum() for g in grads))
    for max_norm in (norm / 3, norm, norm * 2):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        params = [torch.zeros(g.shape, dtype=torch.float64, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = _t(g)
        TE.clip_grad_global_norm_(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-12, atol=0)


def test_freeze_backbone_keeps_the_body(one_step):
    items = one_step["items"]
    model, hist = TE.train_detection_items(
        items, 4, num_steps=1, freeze_backbone=True, init_params=one_step["p0"],
        with_keypoints=True, device="cpu")
    body = "ResNetFPN_0.ResNet_0."
    for k, v in model.state_dict().items():
        assert torch.equal(v, one_step["p0"][k]) == k.startswith(body), k
    assert np.isfinite(hist["loss"][0])
