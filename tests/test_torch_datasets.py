"""The port's stereo datasets against the JAX package's on the same fixture
trees (written under tmp_path): Middlebury 2014, Middlebury 2005 in both
layouts, KITTI 2015 and the unary cache. Both are numpy on the host, so
every item must hold the same keys, shapes, dtypes and values."""
import numpy as np
import pytest
from PIL import Image

from depth_estimation_torch.data import datasets as T
from depth_estimation_torch.utils.io import write_pfm
from depth_estimation_tpu.data import datasets as J


def _png(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _rgb(rs, h, w):
    return (rs.rand(h, w, 3) * 255).astype(np.uint8)


def _same_items(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _same_datasets(t, j):
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        _same_items(t[i], j[i])


@pytest.fixture
def middlebury2014(tmp_path):
    rs = np.random.RandomState(0)
    for scene, gt in (("Adirondack", True), ("Jadeplant", True), ("Motorcycle", False)):
        d = tmp_path / scene
        _png(d / "im0.png", _rgb(rs, 24, 36))
        _png(d / "im1.png", _rgb(rs, 24, 36))
        if gt:
            disp = (rs.rand(24, 36) * 60).astype(np.float32)
            disp[3, 5] = np.inf  # Middlebury marks unknown disparities so
            write_pfm(d / "disp0.pfm", disp)
    (tmp_path / "notes").mkdir()
    return tmp_path


@pytest.mark.parametrize("downsize", [1, 2, 4])
def test_middlebury2014_matches_jax(middlebury2014, downsize):
    t = T.MiddleburyStereo2014(str(middlebury2014), downsize=downsize)
    _same_datasets(t, J.MiddleburyStereo2014(str(middlebury2014), downsize=downsize))
    assert t.scenes == ["Adirondack", "Jadeplant", "Motorcycle"]
    item = t[0]
    assert item["left"].shape == (-(-24 // downsize), -(-36 // downsize), 3)
    assert np.isfinite(item["disparity"]).all() and "disparity" not in t[2]
    if downsize == 1:
        assert item["disparity"][3, 5] == 0.0


def test_middlebury2014_missing_root_is_empty(tmp_path):
    assert len(T.MiddleburyStereo2014(str(tmp_path / "absent"))) == 0


@pytest.fixture
def middlebury2005(tmp_path):
    """'Laundry' and 'Art' in the 2005 layout (view1.png, disp1.png), 'Dolls'
    and 'Books' in the 2014-style one (im0.png, disp0.pfm, an inf value)."""
    rs = np.random.RandomState(1)
    for scene in ("Laundry", "Art"):
        _png(tmp_path / scene / "view1.png", _rgb(rs, 40, 48))
        _png(tmp_path / scene / "disp1.png", (rs.rand(40, 48) * 200).astype(np.uint8))
    for scene in ("Dolls", "Books"):
        _png(tmp_path / scene / "im0.png", _rgb(rs, 40, 48))
        disp = (rs.rand(40, 48) * 70).astype(np.float32)
        disp[7, 9] = np.inf
        write_pfm(tmp_path / scene / "disp0.pfm", disp)
    return tmp_path


@pytest.mark.parametrize("val", [False, True])
@pytest.mark.parametrize("downsize", [4, 8])
def test_middlebury2005_matches_jax(middlebury2005, val, downsize):
    t = T.MiddleburyStereo2005(str(middlebury2005), downsize=downsize, val=val)
    _same_datasets(t, J.MiddleburyStereo2005(str(middlebury2005), downsize=downsize, val=val))
    assert t.scenes == (["Art", "Books"] if val else ["Laundry", "Dolls"])
    for item in (t[0], t[1]):
        assert set(item) == {"disp_lowres", "image", "disparity", "scene"}
        assert item["disparity"].shape == (40, 48) and np.isfinite(item["disparity"]).all()
        assert item["disp_lowres"].shape == (-(-40 // downsize), -(-48 // downsize))
    assert T.TRAIN_SCENES_2005 == J.TRAIN_SCENES_2005
    assert T.VAL_SCENES_2005 == J.VAL_SCENES_2005


@pytest.fixture
def kitti(tmp_path):
    rs = np.random.RandomState(2)
    for frame, gt in (("000000_10", True), ("000001_10", False)):
        _png(tmp_path / "image_2" / f"{frame}.png", _rgb(rs, 20, 30))
        _png(tmp_path / "image_3" / f"{frame}.png", _rgb(rs, 20, 30))
        _png(tmp_path / "image_2" / f"{frame[:6]}_11.png", _rgb(rs, 20, 30))  # not a frame
        if gt:
            raw = (rs.rand(20, 30) * 256 * 90).astype(np.uint16)
            raw[0, :4] = 0  # no ground truth there
            _png(tmp_path / "disp_occ_0" / f"{frame}.png", raw)
            _png(tmp_path / "obj_map" / f"{frame}.png", (rs.rand(20, 30) * 4).astype(np.uint8))
    return tmp_path


@pytest.mark.parametrize("downsize", [1, 2])
def test_kitti2015_matches_jax(kitti, downsize):
    t = T.KITTIStereo2015(str(kitti), downsize=downsize)
    _same_datasets(t, J.KITTIStereo2015(str(kitti), downsize=downsize))
    assert t.frames == ["000000_10", "000001_10"]
    item = t[0]
    assert set(item) == {"left", "right", "frame", "disparity", "obj_map"}
    raw = np.asarray(Image.open(kitti / "disp_occ_0" / "000000_10.png"), np.float64)
    np.testing.assert_array_equal(item["disparity"],
                                  raw[::downsize, ::downsize] / 256.0 / downsize)
    assert set(t[1]) == {"left", "right", "frame"}


def test_unary_cache_matches_jax(tmp_path):
    """get, put and get_or_compute (the function runs once); either
    package's cache reads what the other wrote."""
    calls = []
    vol = np.random.RandomState(3).rand(4, 5, 6).astype(np.float32)

    def compute():
        calls.append(1)
        return {"unary": vol, "scale": np.float64(2.5)}

    t = T.UnaryCache(str(tmp_path / "cache"))
    assert t.get("Adirondack/ds4") is None
    first = t.get_or_compute("Adirondack/ds4", compute)
    again = t.get_or_compute("Adirondack/ds4", compute)
    assert len(calls) == 1
    np.testing.assert_array_equal(again["unary"], vol)
    assert again["unary"].dtype == np.float32 and float(again["scale"]) == 2.5
    _same_items(first, compute())
    j = J.UnaryCache(str(tmp_path / "cache"))
    _same_items(j.get("Adirondack/ds4"), again)
    j.put("Jadeplant/ds4", {"unary": vol[::-1]})
    np.testing.assert_array_equal(t.get("Jadeplant/ds4")["unary"], vol[::-1])
    assert t._path("k") == j._path("k")
