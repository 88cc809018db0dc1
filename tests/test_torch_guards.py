"""Guards of the PyTorch port: it imports without JAX and never names the
JAX package, its subpackages re-export the JAX package's names, its entry
points default to the GPU and refuse to fall back to the CPU, and the fused
update's wrappers take their plain version only for CPU tensors."""
import ast
import importlib
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import depth_estimation_torch
from depth_estimation_torch.apps import detect, infer, segment, train_crf, train_detect, upsample
from depth_estimation_torch.models.detection.rcnn import MaskRCNN
from depth_estimation_torch.models import pipeline as TP
from depth_estimation_torch.models import refiner as TR
from depth_estimation_torch.models.serving import StereoServer
from depth_estimation_torch.ops.spectral import spectral_segment
from depth_estimation_torch.parallel.mesh import make_mesh
from depth_estimation_torch.parallel.stereo_tiled import crf_stereo_infer_tiled
from depth_estimation_torch.ops.cuda import meanfield as K
from depth_estimation_torch.train import experiments as TE
from depth_estimation_torch.train.trainer import Trainer
from depth_estimation_torch.utils import build
from depth_estimation_torch.utils.device import resolve_device
from depth_estimation_torch.utils.profiling import StageTimer
from depth_estimation_torch.utils.timing import chain_timer, loop_timer
from depth_estimation_torch.utils.weights import load_jax_params, params_from_jax

PKG = pathlib.Path(depth_estimation_torch.__file__).parent
REPO = PKG.parent


def _modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


# the modules of the training slice, of the serving, multi-device and
# operator slice and of the detection slice, which the two checks below
# must reach
SLICE_MODULES = [f"depth_estimation_torch.{m}" for m in (
    "ops.guided_filter", "models.features", "models.refiner", "train.experiments",
    "train.trainer", "apps.train_crf", "apps.upsample",
    "parallel.mesh", "parallel.tiling", "parallel.stereo_tiled", "models.serving",
    "models.maskdepth", "ops.spectral", "ops.classical", "ops.lsh", "apps.segment", "config",
    "utils.timing", "utils.profiling", "utils.memory",
    "ops.detection", "models.detection.anchors", "models.detection.backbone",
    "models.detection.rcnn", "models.detection.losses", "models.detection.tta",
    "data.shapes", "data.coco", "data.loader", "train.eval_detection", "utils.visualize",
    "utils.weights", "apps.detect", "apps.train_detect",
    "ops.cuda.meanfield", "ops.boxfilter", "ops.costvolume", "data.datasets", "utils.native",
    "utils.build")]


def test_every_module_imports_without_jax():
    assert set(SLICE_MODULES) <= set(_modules())
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k.startswith(('jax', 'depth_estimation_tpu')) for k in sys.modules"
            " if sys.modules[k] is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_file_names_the_jax_package():
    files = [p for p in PKG.rglob("*") if p.is_file() and p.suffix in (".py", ".cu", ".cuh")]
    assert any(p.suffix == ".cu" for p in files)
    named = {".".join(p.relative_to(REPO).with_suffix("").parts) for p in files}
    assert set(SLICE_MODULES) <= named
    for p in files:
        text = p.read_text()
        assert "depth_estimation_tpu" not in text, p
        assert "import jax" not in text and "from jax" not in text, p


# JAX re-exports that the port spells differently (the subpackage's
# docstring maps each), or leaves at its module to keep the module importable
RENAMED = {
    "models": {"crf_rnn_apply", "crf_rnn_init", "refiner_apply", "refiner_init",
               "uncertainty_apply", "uncertainty_init", "upsampler_apply", "upsampler_init"},
    "parallel": {"data_sharding", "replicated"},
    "ops": {"guided_filter"},
}
PORT_NAMES = {"models": {"CRFasRNN", "CRFDepthRefiner", "CRFWithUncertainty",
                         "CRFDepthUpsampler"},
              "parallel": {"shard_batch", "broadcast_"}}


def _reexports(init: pathlib.Path) -> dict[str, set[str]]:
    """{leaf module: names} of an `__init__`'s `from .leaf import ...` lines."""
    out = {}
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            out.setdefault(node.module, set()).update(a.name for a in node.names)
    return out


@pytest.mark.parametrize("sub", ["ops", "crf", "data", "models", "train", "parallel"])
def test_subpackages_reexport_the_jax_names(sub):
    """Every name the JAX package's subpackage re-exports is re-exported by
    the port's under the same name, from the same leaf module, and is that
    module's object; or it is one the port spells differently, whose port
    name is re-exported and mapped in the docstring."""
    pkg = importlib.import_module(f"depth_estimation_torch.{sub}")
    jax_names = _reexports(REPO / "depth_estimation_tpu" / sub / "__init__.py")
    for leaf, names in jax_names.items():
        mod = importlib.import_module(f"depth_estimation_torch.{sub}.{leaf}")
        for name in names - RENAMED.get(sub, set()):
            assert getattr(pkg, name) is getattr(mod, name), (sub, name)
    for name in RENAMED.get(sub, set()) - {"guided_filter"}:
        assert not hasattr(pkg, name)
        assert name.split("_")[0] in pkg.__doc__ or name in pkg.__doc__, name
    for name in PORT_NAMES.get(sub, set()):
        assert hasattr(pkg, name) and name in pkg.__doc__, name
    assert set().union(*jax_names.values()) >= RENAMED.get(sub, set())


def test_every_reexport_resolves():
    """Each name an `__init__` of the port imports, or loads at first use,
    resolves; `ops.guided_filter` stays the module."""
    for init in PKG.rglob("__init__.py"):
        pkg = importlib.import_module(".".join(init.parent.relative_to(REPO).parts))
        for leaf, names in _reexports(init).items():
            for name in names:
                assert getattr(pkg, name) is not None, (pkg.__name__, name)
        for name in getattr(pkg, "_LAZY", {}):
            assert callable(getattr(pkg, name)), name
    ops = importlib.import_module("depth_estimation_torch.ops")
    assert ops.guided_filter.__name__ == "depth_estimation_torch.ops.guided_filter"
    assert ops.spectral_segment.__module__ == "depth_estimation_torch.ops.spectral"
    with pytest.raises(AttributeError):
        ops.no_such_name


def test_entry_points_default_to_the_gpu(tmp_path):
    from PIL import Image

    from depth_estimation_torch.utils.io import write_pfm

    left = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    cfg = TP.CRFStereoConfig(num_disp=4, niters=1)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    Image.fromarray((left * 255).astype(np.uint8)).save(tmp_path / "l.png")
    write_pfm(tmp_path / "d.pfm", left[..., 0])
    no_gpu = [
        lambda: Trainer(lambda m, b: 0, lambda ps: None),
        lambda: TE.TrainableDenseCRF(),
        lambda: TE.train_tsukuba_crf(left, left, left[..., 0], num_steps=1),
        lambda: TE.train_uncertainty([{"left": left, "right": left, "disparity": left[..., 0]}]),
        lambda: TE.train_upsampler([{"disp_lowres": left[::2, ::2, 0], "image": left,
                                     "disparity": left[..., 0]}]),
        lambda: TR.CRFasRNN(),
        lambda: load_jax_params(torch.nn.Linear(1, 1, bias=False), {"weight": np.ones((1, 1))}),
        lambda: train_crf.main(["--left", str(tmp_path / "l.png"), "--right",
                                str(tmp_path / "l.png"), "--gt", str(tmp_path / "d.pfm")]),
        lambda: upsample.main(["--disp", str(tmp_path / "d.pfm"), "--image",
                               str(tmp_path / "l.png")]),
        lambda: StereoServer(cfg),
        lambda: crf_stereo_infer_tiled(left, left, cfg, make_mesh()),
        lambda: spectral_segment(left),
        lambda: segment.main(["--image", str(tmp_path / "l.png")]),
        lambda: StageTimer(),
        lambda: chain_timer(lambda acc: acc),
        lambda: loop_timer(lambda acc: acc),
        lambda: MaskRCNN(),
        lambda: TE.train_detection_shapes(num_steps=1),
        lambda: TE.train_detection_shapes_batched(num_steps=1),
        lambda: detect.main(["--image", str(tmp_path / "l.png")]),
        lambda: train_detect.main(["--steps", "1"]),
    ]
    for call in no_gpu:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.crf_stereo_infer(left, left, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.calibrate_capacity(left, cfg, tiled=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.ones(3, np.float32)})
    assert resolve_device("cpu").type == "cpu"
    assert params_from_jax({"w": np.ones(3, np.float32)}, device="cpu")["w"].device.type == "cpu"


def test_cpu_tensors_take_the_plain_version_uncounted():
    rs = np.random.RandomState(1)
    E0, S, C = (torch.from_numpy(rs.rand(100, 16).astype(np.float32)) for _ in range(3))
    Mu = torch.from_numpy(rs.rand(16, 16).astype(np.float32))
    before = K.fused_energy_update.launches
    E, Cn = K.fused_energy_update(E0, S, C, Mu)
    assert K.fused_energy_update.launches == before
    E_r, C_r = K.fused_energy_update_reference(E0, S, C, Mu)
    assert torch.equal(E, E_r) and torch.equal(Cn, C_r)


def test_cpu_pipeline_counts_no_launch():
    left = np.random.RandomState(2).rand(32, 64, 3).astype(np.float32)
    cfg = TP.CRFStereoConfig(num_disp=8, niters=2, fused_update=True)
    before = K.fused_energy_update.launches
    out = TP.crf_stereo_infer(left, left, cfg, device="cpu")
    assert K.fused_energy_update.launches == before
    assert out["disparity"].device.type == "cpu"


def test_build_is_keyed_by_source_and_out_of_git():
    """Libraries land in the ignored build directory under a name that
    changes with the source and the nvcc flags, which target sm_90a."""
    target = build._target("meanfield")
    assert target.parent == build.BUILD_DIR and target.name.startswith("libmeanfield-")
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "depth_estimation_torch/_build/" in ignored
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == ["meanfield", "meanfield_wide",
                                                               "meanfield_wide_ffma",
                                                               "meanfield_xwide"]
    assert build._target("meanfield_wide").name.startswith("libmeanfield_wide-")
    assert build._target("meanfield_wide_ffma").name.startswith("libmeanfield_wide_ffma-")
    assert build._target("meanfield_xwide").name.startswith("libmeanfield_xwide-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert ("-Xptxas", "-v") in zip(build.NVCC_FLAGS, build.NVCC_FLAGS[1:])


def test_build_is_keyed_by_every_header(tmp_path, monkeypatch):
    """Editing, adding or removing a header under csrc/ changes the library
    that a source builds into, so a stale build is never reused."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    header = csrc / "common.cuh"
    header.write_text("#pragma once\n")
    seen = {build._target("meanfield")}
    assert build._target("meanfield") in seen  # stable while nothing changes
    header.write_text(header.read_text() + "// edited\n")
    seen.add(build._target("meanfield"))
    (csrc / "extra.h").write_text("#pragma once\n")
    seen.add(build._target("meanfield"))
    (csrc / "extra.h").unlink()
    header.unlink()
    seen.add(build._target("meanfield"))
    assert len(seen) == 4
    assert all(p.parent == tmp_path / "_build" for p in seen)


def test_infer_cli_on_cpu(tmp_path, capsys):
    from PIL import Image

    from depth_estimation_torch.data.synthetic import make_stereo_pair
    from depth_estimation_torch.utils.io import read_pfm

    left, right, gt = make_stereo_pair(np.random.RandomState(3), 64, 64, max_disp=5)
    for name, img in (("l.png", left), ("r.png", right)):
        Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / name)
    args = ["--left", str(tmp_path / "l.png"), "--right", str(tmp_path / "r.png"),
            "--out", str(tmp_path / "d.pfm"), "--labels", "8", "--iters", "2",
            "--device", "cpu", "--fast"]
    assert infer.main(args) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"device": "cpu"' in line
    disp = read_pfm(tmp_path / "d.pfm")
    assert disp.shape == (64, 64) and np.isfinite(disp).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer.main(args[:-3] + ["--fast"])


def test_upsample_cli_on_cpu(tmp_path, capsys):
    from PIL import Image

    from depth_estimation_torch.utils.io import read_pfm, write_pfm

    img = np.random.RandomState(4).rand(32, 48, 3).astype(np.float32)
    Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / "img.png")
    disp = np.full((32, 48), 2.0, np.float32)
    disp[:, 24:] = 6.0
    write_pfm(tmp_path / "low.pfm", disp[::4, ::4])
    write_pfm(tmp_path / "gt.pfm", disp)
    args = ["--disp", str(tmp_path / "low.pfm"), "--image", str(tmp_path / "img.png"),
            "--out", str(tmp_path / "up.pfm"), "--gt", str(tmp_path / "gt.pfm"),
            "--iters", "1", "--radius", "3", "--device", "cpu"]
    assert upsample.main(args) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"device": "cpu"' in line and "masked_l1" in line
    up = read_pfm(tmp_path / "up.pfm")
    assert up.shape == (32, 48) and np.isfinite(up).all()
