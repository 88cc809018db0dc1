"""The PyTorch port's numpy-only helpers (synthetic data, IO, datasets)
agree with the JAX package's bit for bit."""
import numpy as np
import pytest

from depth_estimation_torch.data import datasets as Tds
from depth_estimation_torch.data import synthetic as Ts
from depth_estimation_torch.utils import io as Tio
from depth_estimation_tpu.data import datasets as Jds
from depth_estimation_tpu.data import synthetic as Js
from depth_estimation_tpu.utils import io as Jio


@pytest.mark.parametrize("seed", [0, 5])
def test_make_stereo_pair_bit_for_bit(seed):
    a = Ts.make_stereo_pair(np.random.RandomState(seed), 48, 64)
    b = Js.make_stereo_pair(np.random.RandomState(seed), 48, 64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(Ts.random_texture(np.random.RandomState(seed), 8, 9),
                                  Js.random_texture(np.random.RandomState(seed), 8, 9))


def test_pfm_pgm_round_trip(tmp_path):
    img = np.random.RandomState(0).rand(5, 7, 3).astype(np.float32)
    Tio.write_pfm(tmp_path / "a.pfm", img)
    np.testing.assert_array_equal(Tio.read_pfm(tmp_path / "a.pfm"), img)
    np.testing.assert_array_equal(Jio.read_pfm(tmp_path / "a.pfm"), img)
    raw = np.arange(12, dtype=np.uint8).reshape(3, 4)
    (tmp_path / "a.pgm").write_bytes(b"P5\n# c\n4 3\n255\n" + raw.tobytes())
    np.testing.assert_array_equal(Tio.read_pgm(tmp_path / "a.pgm"), raw)


def test_tsukuba_pair_reads_env_dir(tmp_path, monkeypatch):
    from PIL import Image

    rs = np.random.RandomState(1)
    for name in ("imL.png", "imR.png"):
        Image.fromarray((rs.rand(6, 8, 3) * 255).astype(np.uint8)).save(tmp_path / name)
    gt = (rs.rand(6, 8) * 255).astype(np.uint8)
    (tmp_path / "truedisp.row3.col3.pgm").write_bytes(b"P5\n8 6\n255\n" + gt.tobytes())
    monkeypatch.setenv("DET_TSUKUBA_DIR", str(tmp_path))
    pair = Tds.TsukubaPair()
    assert pair.available()
    got = pair.load(downsize=2)
    want = Jds.TsukubaPair(root=str(tmp_path)).load(downsize=2)
    for k in ("left", "right", "disparity"):
        np.testing.assert_array_equal(got[k], want[k])
    monkeypatch.delenv("DET_TSUKUBA_DIR")
    assert not Tds.TsukubaPair().available()
