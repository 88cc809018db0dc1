"""Guards of the PyTorch port: it imports without JAX and never names the
JAX package, its entry points default to the GPU and refuse to fall back
to the CPU, and the fused update's wrapper takes its plain version only
for CPU tensors."""
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import depth_estimation_torch
from depth_estimation_torch.apps import infer
from depth_estimation_torch.models import pipeline as TP
from depth_estimation_torch.ops.cuda import meanfield as K
from depth_estimation_torch.utils import build
from depth_estimation_torch.utils.device import resolve_device
from depth_estimation_torch.utils.weights import params_from_jax

PKG = pathlib.Path(depth_estimation_torch.__file__).parent
REPO = PKG.parent


def _modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax():
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
    for p in files:
        text = p.read_text()
        assert "depth_estimation_tpu" not in text, p
        assert "import jax" not in text and "from jax" not in text, p


def test_entry_points_default_to_the_gpu():
    left = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    cfg = TP.CRFStereoConfig(num_disp=4, niters=1)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
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
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == ["meanfield"]
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
