"""The port's scaled detection tools (`depth_estimation_torch.tools.
train_detect_scaled`, `train_coco_scaled`) against the JAX system's
`tools/train_detect_scaled.py` and `tools/train_coco_scaled.py` on the CPU.

The synthetic torchvision checkpoint is bit-equal to the JAX tool's; the
port's graft of it equals the JAX graft carried across by
`utils.weights.state_dict_from_jax` (both fresh models from the same flax
init) bit for bit, at blocks (1, 1, 1, 1), width 16, FPN 32; the exported
COCO tree has the same json and the same png pixels as the JAX tool's. One
CLI run of each tool at 64×64 on the CPU: the heads phase leaves the
grafted body bit-equal, the all-layers phase moves every parameter, and
--save/--resume round-trips the state dict."""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_torch.models.detection.rcnn import MaskRCNN
from depth_estimation_torch.tools import train_coco_scaled as TC
from depth_estimation_torch.tools import train_detect_scaled as TD
from depth_estimation_torch.utils import weights as W

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(blocks=(1, 1, 1, 1), width=16, fpn_dim=32)
CLI_SMALL = ["--device", "cpu", "--size", "64", "--items", "2", "--holdout", "1"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small runs gain little from more
    (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str):
    """A JAX tool loaded by path (numpy until its `main`)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("blocks,width,seed", [((2, 2, 2, 2), 64, 7), ((1, 1, 1, 1), 16, 3)])
def test_synthetic_checkpoint_is_bit_equal(blocks, width, seed):
    want = _jax_tool("train_detect_scaled").synth_torch_resnet_sd(blocks, width, seed=seed)
    got = TD.synth_torch_resnet_sd(blocks, width, seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_graft_matches_the_jax_graft():
    from depth_estimation_tpu.models.detection.rcnn import MaskRCNN as JMaskRCNN
    from depth_estimation_tpu.utils import weights as JW

    blocks, width, fpn = SMALL["blocks"], SMALL["width"], SMALL["fpn_dim"]
    kw = TD.model_kwargs(blocks, width, fpn)
    assert kw["stride_1x1"] == JW.resnet_import_kwargs("torch")["stride_1x1"]
    jax_model = JMaskRCNN(**kw)
    fresh = jax.jit(lambda key, img: jax_model.init(key, img, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((64, 64, 3), jnp.float32))
    sd = _jax_tool("train_detect_scaled").synth_torch_resnet_sd(blocks, width, seed=7)
    jax_grafted = JW.graft_backbone(fresh, JW.torch_resnet_params(sd, blocks=blocks))

    model = MaskRCNN(device="cpu", **kw)
    fresh_port = W.state_dict_from_jax(model, fresh["params"])
    got = TD.graft(fresh_port, blocks, width, seed=0)
    want = W.state_dict_from_jax(model, jax_grafted["params"])
    assert set(got) == set(want) == set(model.state_dict())
    body = [k for k in want if k.startswith(TD.BODY)]
    assert body and any(not torch.equal(fresh_port[k], want[k]) for k in body)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_cli_two_phases_and_resume(tmp_path, capsys):
    save, out = tmp_path / "params.pt", tmp_path / "result.json"
    res = TD.main(CLI_SMALL + ["--steps", "2", "--save", str(save), "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["heldout_map50"] == res["heldout_map50"]
    assert res["losses_finite"] and len(res["step_ms"]["heads"]) == len(res["step_ms"]["all"]) == 1
    assert res["heads_phase_body_unchanged"] is True
    assert res["params_unmoved_last_phase"] == []
    assert json.loads(out.read_text())["loss_first"] == res["loss_first"]
    assert res["config"]["blocks"] == [2, 2, 2, 2] and res["config"]["fpn_dim"] == 128
    saved = torch.load(save, weights_only=True)
    assert any(k.startswith(TD.BODY) for k in saved)

    resumed = TD.main(CLI_SMALL + ["--steps", "1", "--resume", str(save)])
    assert resumed["resumed_from"] == str(save) and resumed["step_ms"]["heads"] == []
    assert resumed["heads_phase_body_unchanged"] is None and resumed["losses_finite"]


def test_export_matches_the_jax_tool(tmp_path):
    _, ann = TC.export_coco_tree(str(tmp_path / "port"), 4, 32, seed=3)
    _, jax_ann = _jax_tool("train_coco_scaled").export_coco_tree(str(tmp_path / "jax"), 4, 32, 3)
    got, want = json.loads(pathlib.Path(ann).read_text()), json.loads(pathlib.Path(jax_ann).read_text())
    assert got == want and len(got["images"]) == 4 and got["annotations"]
    for im in want["images"]:
        a = np.asarray(Image.open(tmp_path / "port" / "images" / im["file_name"]))
        b = np.asarray(Image.open(tmp_path / "jax" / "images" / im["file_name"]))
        assert a.shape == (32, 32, 3) and np.array_equal(a, b)


def test_coco_cli_step(tmp_path, capsys):
    res = TC.main(["--device", "cpu", "--size", "64", "--steps", "1", "--items", "3", "--holdout",
                   "1", "--data-dir", str(tmp_path / "tree"), "--out", str(tmp_path / "r.json")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "loss_curve_every25" not in line and line["items_read"] == 3
    assert res["losses_finite"] and len(res["step_ms"]) == 1
    assert json.loads((tmp_path / "r.json").read_text())["loss_curve_every25"] == res["loss_curve_every25"]
    assert (tmp_path / "tree" / "ann.json").exists()


def test_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.main(["--steps", "1", "--data-dir", str(tmp_path)])
