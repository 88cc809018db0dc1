"""The port's benchmark line (`bench_torch.py`) against the JAX system's
`bench.py`, and its scaling sweep (`depth_estimation_torch.tools.
bench_scaling`) against `tools/bench_scaling.py`, on the CPU.

`bench_torch.main` prints exactly the keys of `bench.py`'s line (read from
the dict literal that its `main` prints) with the flag defaults of its
argument parser; its configuration, calibrated on the noise pair, is what
the JAX package's `calibrate_capacity` gives in-process on the same float32
pair; `iteration_traffic_bytes` is `bench.py`'s byte count (its expression,
read from its source and evaluated); `--pair` and `--dense-baseline` run.
The bench runs at 32×64 here, not the JAX bench's usual CPU check at 64×96:
on noise the calibrated tiles hold up to 6144 vertices each, and at 64×96 a
run takes about 28 s on one CPU thread. The scaling sweep's 2-rank gloo world
at 24×32, 8 labels, gathers each frame's disparity equal to a one-process
run of the same configuration, and its line has the JAX tool's keys."""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import bench_torch as B
from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models.pipeline import crf_stereo_infer
from depth_estimation_torch.ops.cuda import meanfield as K
from depth_estimation_torch.tools import bench_scaling as BS

REPO = pathlib.Path(__file__).resolve().parent.parent
ARGV = ["--device", "cpu", "--h", "32", "--w", "64", "--reps", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small runs gain little from more
    (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _function(path: str, name: str) -> ast.FunctionDef:
    tree = ast.parse((REPO / path).read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _bench_py_keys() -> tuple[list[str], list[str]]:
    """The keys of `bench.py`'s line and of its `detail`, in order."""
    line = next(n for n in ast.walk(_function("bench.py", "main")) if isinstance(n, ast.Dict)
                and any(getattr(k, "value", None) == "metric" for k in n.keys))
    detail = line.values[[k.value for k in line.keys].index("detail")]
    return [k.value for k in line.keys], [k.value for k in detail.keys]


def _bench_py_defaults() -> dict:
    """{flag: default} of `bench.py`'s argument parser."""
    out = {}
    for call in ast.walk(_function("bench.py", "_argparser")):
        if isinstance(call, ast.Call) and getattr(call.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in call.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else None
            out[call.args[0].value] = False if kw.get("action") and default is None else default
    return out


def _run(capsys, argv) -> tuple[dict, dict]:
    """The bench's JSON line (printed and returned) and its standard error's
    launch and occupancy record."""
    ret = B.main(argv)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == ret
    return line, json.loads(next(x for x in err.splitlines() if x.startswith("{")))


def test_line_has_bench_py_keys_and_jax_calibration(capsys):
    import jax.numpy as jnp

    from depth_estimation_tpu.models.pipeline import CRFStereoConfig, calibrate_capacity

    line, info = _run(capsys, ARGV)
    keys, detail_keys = _bench_py_keys()
    assert list(line) == keys and list(line["detail"]) == detail_keys
    d = line["detail"]
    assert line["metric"] == "crf_meanfield_iters_per_s" and line["value"] > 0
    assert line["unit"] == "iters/s/chip (32x64px, L=16, d=5 bilateral)"
    assert (line["vs_baseline"], d["vs_baseline_source"]) == (1.0, None)
    assert (d["device"], d["niters"], d["max_pieces"], d["order_by_sum"]) == ("cpu", 5, None,
                                                                              False)
    assert d["pipeline_ms"] > 0
    assert d["iter_ms"] is None or (d["iter_ms"] > 0 and 0 < d["roofline_fraction"] <= 1.0)
    left = np.random.RandomState(0).rand(32, 64, 3).astype(np.float32)
    jcfg = calibrate_capacity(jnp.asarray(left), CRFStereoConfig(num_disp=16, niters=5),
                              headroom=3.0, pieces=False, tiled=True, tile_px=32)
    assert (d["max_vertices"], d["tile_px"], d["tile_u"], d["sort_mode"]) == (
        jcfg.max_vertices, jcfg.tile_px, jcfg.tile_u, jcfg.sort_mode)
    assert info["launches_per_call"] == {k: 0 for k in K.KERNELS}  # the CPU's plain version
    assert 0 < info["num_valid"] <= d["max_vertices"] and info["tile_overflow"] == 0


def test_flag_defaults_are_bench_py_defaults():
    jax_defaults = _bench_py_defaults()
    port = vars(B.parse_args([]))
    shared = {k.lstrip("-").replace("-", "_") for k in jax_defaults} & set(port)
    assert shared >= {"labels", "niters", "h", "w", "reps", "headroom",
                      "order_by_sum", "tiled", "fused", "dtype", "sort_mode", "tile_px",
                      "dense_baseline", "device"}
    for name in shared - {"device"}:
        assert port[name] == jax_defaults["--" + name.replace("_", "-")], name
    assert port["device"] == "cuda" and port["pair"] is None


@pytest.mark.parametrize("h,w,L,C", [(288, 384, 16, 32768), (994, 1482, 64, 131072)])
def test_iteration_traffic_bytes_is_bench_py_count(h, w, L, C):
    """`bench.py`'s expression for `traffic`, evaluated on its own names."""
    src = (REPO / "bench.py").read_text()
    node = next(n for n in ast.walk(_function("bench.py", "main")) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "traffic")
    n, d = h * w, 5
    want = eval("(" + ast.get_source_segment(src, node.value) + ")",
                {"n": n, "L": L, "d": d, "C": C, "N": n * (d + 1), "f": 4})
    assert B.iteration_traffic_bytes(h, w, L, d, C) == want
    if (h, w, L, C) == (288, 384, 16, 32768):
        assert want == 204_603_392  # 61.1 µs at 3.35 TB/s


def test_pair_file_and_live_dense_baseline(capsys, tmp_path):
    """--pair: the pair of the .npz at its own size (24×32, edge-padded
    into the 32-px tiles); --dense-baseline: vs_baseline measured in the
    run, against the dense oracle."""
    left, right, _ = make_stereo_pair(np.random.RandomState(2), 24, 32, max_disp=6)
    path = tmp_path / "pair.npz"
    np.savez(path, left=left, right=right)
    line, info = _run(capsys, ["--device", "cpu", "--pair", str(path), "--reps", "2",
                               "--niters", "1", "--dense-baseline"])
    assert line["unit"] == "iters/s/chip (24x32px, L=16, d=5 bilateral)"
    assert line["detail"]["iter_ms"] is None and line["detail"]["niters"] == 1
    assert line["detail"]["vs_baseline_source"] == "dense oracle measured live"
    assert line["vs_baseline"] > 0 and info["num_valid"] <= line["detail"]["max_vertices"]


def _jax_scaling_keys() -> list[str]:
    node = next(n for n in ast.walk(_function("tools/bench_scaling.py", "main"))
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "result")
    return [k.value for k in node.value.keys]


def test_scaling_world_matches_one_process(capsys):
    """A 2-rank gloo world serves 4 frames, 2 a rank, and gathers each
    frame's disparity equal to the one-process pipeline's; a one-rank
    sweep prints the JAX tool's keys, with the note that CPU ranks share
    the host."""
    args = BS.parse_args(["--device", "cpu", "--h", "24", "--w", "32", "--labels", "8",
                          "--reps", "1"])
    seconds, disp = BS.run_world(2, args, "cpu")
    assert seconds > 0 and disp.shape == (4, 24, 32)
    rng = np.random.RandomState(0)
    left, right = (rng.rand(4, 24, 32, 3).astype(np.float32) for _ in range(2))
    cfg = BS.scaling_cfg(24, 32, 8, 5)
    assert cfg.max_vertices == 2048 and cfg.backend == "lattice" and not cfg.fused_update
    for i in range(4):
        one = crf_stereo_infer(left[i], right[i], cfg, device="cpu")["disparity"]
        assert torch.equal(disp[i], one), i

    res = BS.main(["--device", "cpu", "--devices", "1", "--h", "24", "--w", "32",
                   "--labels", "8", "--reps", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert list(res) == _jax_scaling_keys()
    assert res["device"] == "cpu" and res["efficiency_vs_linear"] == {"1": 1.0}
    assert res["frames_per_s"]["1"] > 0 and "share" in res["note"]
    assert res["unit"] == "frames/s (24x32px, L=8, lattice CRF, 2/device)"
