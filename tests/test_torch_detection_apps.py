"""The PyTorch port's detection CLIs on the CPU (`--device cpu`): `detect`
with every output (panel, splash, RLE lines, mask depth, a saved state
dict) and `train_detect` on the procedural shapes, with its checkpoint.
Without a GPU, both refuse their default device."""
import json

import numpy as np
import pytest
import torch

from depth_estimation_torch.apps import detect, train_detect
from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models.detection.rcnn import MaskRCNN
from depth_estimation_torch.utils.io import read_pfm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small float64 runs gain little from
    more (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_detect_cli_on_cpu(tmp_path, capsys):
    from PIL import Image

    left, right, _ = make_stereo_pair(np.random.RandomState(0), 64, 64, max_disp=4)
    for name, img in (("l.png", left), ("r.png", right)):
        Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / name)
    torch.save(MaskRCNN(num_detections=16, blocks=(2, 2, 2, 2), fpn_dim=128,
                        generator=torch.Generator().manual_seed(3), device="cpu").state_dict(),
               tmp_path / "m.pt")
    outs = {k: tmp_path / f"{k}.{ext}" for k, ext in (("out", "png"), ("splash", "png"),
                                                       ("rle", "txt"), ("depth", "pfm"))}
    args = ["--image", str(tmp_path / "l.png"), "--out", str(outs["out"]), "--splash",
            str(outs["splash"]), "--rle-out", str(outs["rle"]), "--right", str(tmp_path / "r.png"),
            "--depth-out", str(outs["depth"]), "--device", "cpu"]
    assert detect.main(args) == 0
    res = _last_json(capsys)
    assert res["device"] == "cpu" and len(res["scores"]) == 16 and 0 <= res["num_valid"] <= 16
    assert np.asarray(Image.open(outs["out"])).shape == (64, 64, 3)
    assert np.asarray(Image.open(outs["splash"])).shape == (64, 64, 3)
    assert outs["rle"].read_text().startswith(str(tmp_path / "l.png"))
    depth = read_pfm(outs["depth"])
    assert depth.shape == (64, 64) and np.isfinite(depth).all()
    assert detect.main(args[:2] + ["--params", str(tmp_path / "m.pt"), "--device", "cpu"]) == 0
    assert _last_json(capsys)["scores"] != res["scores"]  # the saved weights, not seed 0's
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            detect.main(args[:2])


def test_train_detect_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "maskrcnn.pt"
    args = ["--steps", "2", "--items", "2", "--size", "64", "--holdout", "1", "--out", str(out)]
    assert train_detect.main(args + ["--device", "cpu"]) == 0
    res = _last_json(capsys)
    assert res["device"] == "cpu" and res["steps"] == 2 and res["out"] == str(out)
    assert np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"])
    assert 0.0 <= res["map50"] <= 1.0 and res["mask_iou"] is not None
    model = MaskRCNN(num_classes=4, blocks=(1, 1, 1, 1), fpn_dim=32, device="cpu")
    model.load_state_dict(torch.load(out, weights_only=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_detect.main(args)
