"""The PyTorch port's own numpy copies of the detection data modules
(`data/{shapes,coco,loader}.py`), the evaluation (`train/eval_detection.py`)
and the visualisation (`utils/visualize.py`): every output bit-equal to the
JAX package's on the same inputs. Plus the repair of `coco_map` with a
`sim_key` similarity, which the port restricts to the category's GT
columns."""
import json

import numpy as np
import pytest

from depth_estimation_torch.data import coco as TC
from depth_estimation_torch.data import loader as TLd
from depth_estimation_torch.data import shapes as TS
from depth_estimation_torch.train import eval_detection as TEv
from depth_estimation_torch.utils import visualize as TV


def _equal(a, b):
    """Nested dicts / lists / arrays / scalars equal, values and dtypes."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


def test_shapes_dataset_equals_jax():
    from depth_estimation_tpu.data import shapes as JS

    assert (TS.NUM_CLASSES, TS.NUM_KEYPOINTS) == (JS.NUM_CLASSES, JS.NUM_KEYPOINTS)
    for kw in (dict(num_items=3, h=64, w=64, max_shapes=2, seed=0),
               dict(num_items=2, h=40, w=56, max_shapes=3, seed=5)):
        t, j = TS.ShapesDetection(**kw), JS.ShapesDetection(**kw)
        for i in range(kw["num_items"]):
            _equal(t.padded(i, max_gt=4), j.padded(i, max_gt=4))


@pytest.fixture(scope="module")
def coco_fixture(tmp_path_factory):
    """A COCO-format json over 3 images: polygons, an RLE, a bbox-only
    annotation, a crowd annotation and an image file that is missing."""
    from PIL import Image

    d = tmp_path_factory.mktemp("coco")
    rs = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate([(40, 48), (36, 30), (32, 32)]):
        name = f"im{i}.png"
        if i < 2:
            Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(d / name)
        images.append({"id": 10 + i, "file_name": name, "height": h, "width": w})
    rle = TC.encode_rle(np.pad(np.ones((6, 9), bool), ((10, 20), (5, 16))))
    anns = [
        {"id": 1, "image_id": 10, "category_id": 7, "bbox": [4, 5, 20, 14],
         "segmentation": [[4, 5, 24, 5, 24, 19, 4, 19]]},
        {"id": 2, "image_id": 10, "category_id": 3, "bbox": [20, 20, 15, 12],
         "segmentation": [[20, 20, 35, 25, 22.5, 32]]},
        {"id": 3, "image_id": 11, "category_id": 7, "bbox": [5, 10, 9, 6],
         "segmentation": {"counts": rle, "size": [36, 30]}},
        {"id": 4, "image_id": 11, "category_id": 3, "bbox": [1, 1, 6, 8]},
        {"id": 5, "image_id": 12, "category_id": 3, "bbox": [0, 0, 32, 32], "iscrowd": 1},
    ]
    cats = [{"id": 3, "name": "three"}, {"id": 7, "name": "seven"}]
    path = d / "ann.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return str(d), str(path)


def test_coco_modules_equal_jax(coco_fixture):
    from depth_estimation_tpu.data import coco as JC

    root, ann = coco_fixture
    t, j = TC.COCODetection(root, ann), JC.COCODetection(root, ann)
    assert (t.num_classes, t.class_names, len(t)) == (j.num_classes, j.class_names, len(j))
    for i in range(len(t)):
        _equal(t[i], j[i])
        _equal(t.padded(i, size=24, max_gt=3), j.padded(i, size=24, max_gt=3))
        _equal(t.padded(i), j.padded(i))
    rs = np.random.RandomState(1)
    poly = rs.uniform(-3, 30, (7, 2))
    _equal(TC.rasterize_polygon(poly, 25, 28), JC.rasterize_polygon(poly, 25, 28))
    masks = rs.rand(3, 12, 9) > 0.6
    for m in masks:
        assert TC.encode_rle(m) == JC.encode_rle(m)
        _equal(TC.decode_rle(TC.encode_rle(m), 12, 9), m)
        s = TC.rle_submission_encode(m)
        assert s == JC.rle_submission_encode(m)
        _equal(TC.rle_submission_decode(s, 12, 9), JC.rle_submission_decode(s, 12, 9))
    scores = rs.rand(3)
    assert TC.masks_to_submission("x", masks, scores) == JC.masks_to_submission("x", masks, scores)
    assert TC.masks_to_submission("y", masks[:0], scores[:0]) == "y,"


def test_loader_equals_jax():
    from depth_estimation_tpu.data import loader as JL

    shapes = [(30, 40), (50, 20), (32, 32), (20, 60), (45, 44), (60, 30), (25, 26)]
    for bins in ((1.0,), (0.6, 1.0, 1.5)):
        _equal(TLd.aspect_ratio_groups(shapes, bins), JL.aspect_ratio_groups(shapes, bins))
        for epoch in range(2):
            _equal(TLd.GroupedBatchSampler(shapes, 3, bins, seed=4).epoch(epoch),
                   JL.GroupedBatchSampler(shapes, 3, bins, seed=4).epoch(epoch))
    assert list(TLd.GroupedBatchSampler(shapes, 2)) == list(JL.GroupedBatchSampler(shapes, 2))
    rs = np.random.RandomState(2)
    items = [{"image": rs.rand(h, w, 3), "boxes": rs.rand(g, 4) * 10,
              "classes": rs.randint(1, 4, g), "masks": rs.rand(g, h, w) > 0.5}
             for (h, w), g in (((30, 40), 2), ((50, 20), 0), ((33, 45), 3))]
    _equal(TLd.collate_detection_batch(items), JL.collate_detection_batch(items))
    _equal(TLd.collate_detection_batch(items, pad_shape=(64, 64), max_gt=2),
           JL.collate_detection_batch(items, pad_shape=(64, 64), max_gt=2))


def _dataset(seed, n_imgs=5, n_cls=3):
    rs = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_imgs):
        g = rs.randint(1, 5)
        gb = rs.uniform(0, 40, (g, 2))
        gb = np.concatenate([gb, gb + rs.uniform(5, 20, (g, 2))], 1)
        gc = rs.randint(1, n_cls + 1, g)
        p = rs.randint(0, 7)
        pick = rs.randint(0, g, p)
        pb = gb[pick] + rs.normal(0, 3, (p, 4))
        pc = np.where(rs.rand(p) < 0.8, gc[pick], rs.randint(1, n_cls + 1, p))
        preds.append({"boxes": pb, "classes": pc, "scores": rs.rand(p)})
        gts.append({"boxes": gb, "classes": gc})
    return preds, gts


def test_eval_detection_equals_jax():
    from depth_estimation_tpu.train import eval_detection as JEv

    preds, gts = _dataset(0)
    for p, g in zip(preds, gts):
        args = (p["boxes"], p["classes"], p["scores"], g["boxes"], g["classes"])
        for interp in ("all", "coco101"):
            _equal(TEv.compute_ap(*args, interpolation=interp),
                   JEv.compute_ap(*args, interpolation=interp))
        assert TEv.compute_map_range(*args) == JEv.compute_map_range(*args)
        _equal(TEv.match_predictions(*args, 0.3), JEv.match_predictions(*args, 0.3))
        rs = np.random.RandomState(len(p["scores"]))
        pm = rs.rand(len(p["scores"]), 14, 14)
        gm = rs.rand(len(g["classes"]), 48, 48) > 0.5
        assert (TEv.mask_mean_iou(pm, *args[:3], gm, *args[3:])
                == JEv.mask_mean_iou(pm, *args[:3], gm, *args[3:]))
    _equal(TEv.coco_map(preds, gts), JEv.coco_map(preds, gts))
    _equal(TEv.coco_map(preds, gts, thresholds=[0.3, 0.5], max_dets=3),
           JEv.coco_map(preds, gts, thresholds=[0.3, 0.5], max_dets=3))

    rs = np.random.RandomState(3)
    gk = rs.uniform(0, 50, (3, 17, 2))
    pk = np.concatenate([gk + rs.normal(0, 2, gk.shape), rs.uniform(0, 50, (2, 17, 2))])
    areas, vis = rs.uniform(100, 900, 3), rs.rand(3, 17) > 0.2
    _equal(TEv.oks_matrix(pk, gk, areas, gt_vis=vis), JEv.oks_matrix(pk, gk, areas, gt_vis=vis))
    _equal(TEv.oks_matrix(pk[:, :5], gk[:, :5], areas), JEv.oks_matrix(pk[:, :5], gk[:, :5], areas))
    scores = rs.rand(5)
    _equal(TEv.compute_keypoint_ap(pk, scores, gk, areas, gt_vis=vis),
           JEv.compute_keypoint_ap(pk, scores, gk, areas, gt_vis=vis))
    np.testing.assert_array_equal(TEv.COCO_KP_SIGMAS, JEv.COCO_KP_SIGMAS)


def _iou_sim(pred, gt):
    """Box IoU of every prediction against every GT of the image."""
    pb, gb = np.asarray(pred["boxes"], np.float64), np.asarray(gt["boxes"], np.float64)
    if not len(pb) or not len(gb):
        return np.zeros((len(pb), len(gb)))
    return TEv._iou_matrix_np(pb, gb)


def test_coco_map_sim_key_is_restricted_to_the_category():
    """With a similarity over all of an image's GT, each category must read
    only its own GT columns: the port's result equals `coco_map`'s box-IoU
    result, which selects per category. On a single category the JAX
    package's result is matched exactly."""
    from depth_estimation_tpu.train import eval_detection as JEv

    preds, gts = _dataset(1, n_imgs=6, n_cls=2)
    assert len({c for g in gts for c in g["classes"]}) == 2
    _equal(TEv.coco_map(preds, gts, sim_key=_iou_sim), TEv.coco_map(preds, gts))
    # the JAX package reads the wrong GT columns here (ROADMAP queue C)
    assert JEv.coco_map(preds, gts, sim_key=_iou_sim)["map"] != TEv.coco_map(preds, gts)["map"]

    one = [{**p, "classes": np.ones_like(p["classes"])} for p in preds]
    one_gt = [{**g, "classes": np.ones_like(g["classes"])} for g in gts]
    _equal(TEv.coco_map(one, one_gt, sim_key=_iou_sim), JEv.coco_map(one, one_gt, sim_key=_iou_sim))


def test_visualize_equals_jax(tmp_path):
    from PIL import Image

    from depth_estimation_tpu.utils import visualize as JV

    rs = np.random.RandomState(4)
    img = rs.rand(40, 50, 3)
    boxes = np.array([[2, 3, 20, 30], [10, 12, 48, 39], [30, 5, 29, 6], [-4, -2, 60, 50.0]])
    masks, cls, valid = rs.rand(4, 28, 28), np.array([1, 2, 3, 14]), np.array([1, 1, 1, 0], bool)
    _equal(TV.draw_detections(img, boxes, cls, masks=masks, valid=valid),
           JV.draw_detections(img, boxes, cls, masks=masks, valid=valid))
    _equal(TV.draw_detections(img, boxes), JV.draw_detections(img, boxes))
    full = TV.paste_roi_masks(boxes, masks, 40, 50, valid=valid)
    _equal(full, JV.paste_roi_masks(boxes, masks, 40, 50, valid=valid))
    _equal(TV.color_splash(img, full), JV.color_splash(img, full))
    lab = rs.randint(0, 30, (5, 6))
    _equal(TV.colorize_labels(lab), JV.colorize_labels(lab))
    d1, d2 = rs.rand(10, 12) * 8, rs.rand(10, 12) * 8
    _equal(TV.disparity_panel(img[:10, :12], d1, d2, d2), JV.disparity_panel(img[:10, :12], d1, d2, d2))
    TV.save_image(tmp_path / "t.png", img)
    JV.save_image(tmp_path / "j.png", img)
    _equal(np.asarray(Image.open(tmp_path / "t.png")), np.asarray(Image.open(tmp_path / "j.png")))
