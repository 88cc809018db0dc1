"""The port's per-stage profiler CLI (`python -m
depth_estimation_torch.tools.profile_stages`) on the CPU against the JAX
system's `tools/profile_stages.py`: the JAX tool's JSON keys (read from its
source) and the port's own additions; with --fused-update 1 the launches
per pipeline call (none on the CPU); with --pair the pair from a .npz, its
capacity measured on it and the pipeline's EPE against its ground truth;
--tiled refusing a size that is not whole tiles; the GPU by default. The
configuration values are held against the JAX tool's in-process in
tests/test_torch_tools_profile.py."""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models.pipeline import CRFStereoConfig, crf_stereo_infer
from depth_estimation_torch.ops.cuda import meanfield as K
from depth_estimation_torch.tools import profile_stages as PS
from depth_estimation_torch.train.metrics import epe

REPO = pathlib.Path(__file__).resolve().parent.parent
ARGV = ["--device", "cpu", "--h", "32", "--w", "48", "--labels", "4"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small runs gain little from more
    (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli_line(capsys, argv) -> dict:
    PS.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_keys() -> tuple[set[str], list[str]]:
    """The JAX tool's configuration keys and its stages in order, from the
    dict literals `results` and `stages` of its `main`."""
    tree = ast.parse((REPO / "tools" / "profile_stages.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = {n.targets[0].id: [k.value for k in n.value.keys] for n in ast.walk(fn)
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
             and isinstance(n.targets[0], ast.Name)}
    return set(dicts["results"]), dicts["stages"]


def test_cli_prints_the_jax_tools_keys(capsys):
    port = _cli_line(capsys, ARGV + ["--reps", "2"])
    config, stages = _jax_keys()
    assert list(PS.STAGES) == stages
    assert set(port) == config | {f"{s}_ms" for s in stages} | {
        "pair", "h", "w", "compute_dtype", "num_valid", "tile_overflow"}
    assert port["device"] == "cpu" and port["pair"] == "noise"
    assert (port["tiled"], port["tile_px"], port["tile_u"], port["max_pieces"]) == (
        0, None, None, None)
    assert (port["sort_mode"], port["order_by_sum"], port["compute_dtype"]) == (
        "auto", False, "f32")
    assert 0 < port["num_valid"] <= port["capacity"] and port["tile_overflow"] is None


def test_cli_fused_reports_launches_per_call(capsys):
    """On the CPU the fused update takes its plain version: no launch; the
    noise pair has no ground truth, so no EPE."""
    line = _cli_line(capsys, ARGV + ["--reps", "2", "--fused-update", "1", "--stages",
                                     "pipeline"])
    assert line["fused_update"] is True
    assert line["pipeline_launches_per_call"] == {k: 0.0 for k in K.KERNELS}
    assert set(line) >= {"pipeline_ms", "capacity"} and "splat_ms" not in line
    assert "pipeline_epe" not in line and "pipeline_bad2" not in line


def test_tiled_needs_whole_tiles():
    with pytest.raises(ValueError, match="multiples of --tile-px"):
        PS.main(["--device", "cpu", "--h", "30", "--w", "48", "--labels", "4", "--tiled", "1",
                 "--tile-px", "16"])


def test_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.main(["--h", "32", "--w", "48", "--labels", "4"])


def test_cli_profiles_a_pair_from_a_file(capsys, tmp_path):
    """--pair: the stages run on the file's pair, at its size, with the
    capacity measured on it; the pipeline's EPE is that of the same
    configuration's run."""
    left, right, gt = make_stereo_pair(np.random.RandomState(3), 32, 48, max_disp=6)
    path = tmp_path / "pair.npz"
    np.savez(path, left=left, right=right, disparity=gt)
    line = _cli_line(capsys, ["--device", "cpu", "--pair", str(path), "--labels", "8",
                              "--reps", "1", "--compute-dtype", "bf16",
                              "--stages", "pipeline"])
    assert (line["pair"], line["h"], line["w"], line["compute_dtype"]) == (str(path), 32, 48,
                                                                          "bf16")
    assert line["capacity"] != 16384 or line["num_valid"] * 3 > 8192
    assert line["num_valid"] <= line["capacity"]
    cfg = CRFStereoConfig(num_disp=8, niters=5, backend="lattice",
                          max_vertices=line["capacity"], compute_dtype="bf16")
    disp = crf_stereo_infer(left, right, cfg, device="cpu")["disparity"]
    g = torch.as_tensor(gt, dtype=torch.float32)
    want = float(epe(disp, g, (g > 0).float()))
    assert line["pipeline_epe"] == pytest.approx(want, rel=1e-6)
    assert 0.0 <= line["pipeline_bad2"] <= 1.0
    assert "pipeline_ms" in line and "blur_ms" not in line



def test_launch_counts_read_and_zero_every_kernel():
    """The one registry of the fused-update kernels' counts that the
    profiler reads: every wrapper, by name, and a zeroing of them all."""
    saved = K.launch_counts()
    try:
        for i, fn in enumerate(K.KERNELS.values()):
            fn.launches = i + 1
        assert K.launch_counts() == {name: i + 1 for i, name in enumerate(K.KERNELS)}
        assert set(K.KERNELS) == {"K1", "K1w", "K1x", "K1xx"}
        K.zero_launch_counts()
        assert set(K.launch_counts().values()) == {0}
    finally:
        for name, n in saved.items():
            K.KERNELS[name].launches = n
