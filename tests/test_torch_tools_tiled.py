"""The port's tiled stereo study (`depth_estimation_torch.tools.tiled_stereo_study`)
against the JAX system's `tools/tiled_stereo_study.py` on the CPU.

The halo mode runs on a Tsukuba-layout fixture tree written under tmp_path
(a 96×64 synthetic pair, its disparity ×16 as an 8-bit PGM), over 2 row
stripes of 48 rows, at halos 8 and 16 (the tool's sweep monkeypatched):
the port's tool on a 2-rank gloo world, pointed at the tree through
`DET_TSUKUBA_DIR`, against the JAX package's `crf_stereo_infer_tiled` on 2
of the 8 virtual CPU devices, reading the same tree, with the measures of
the JAX tool's `run_halo`.
Their per-halo interior deltas against the untiled pipeline, EPE and bad-2
agree within 5e-3 (px, or a ratio), and the port reports the JAX tool's
keys (read from its source). The time mode runs at its small size and
returns the keys of the JAX tool's `run_time` (read from its source); its
one-tile map at halo 0 is the untiled map."""
import ast
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.tools import tiled_stereo_study as TS

REPO = pathlib.Path(__file__).resolve().parent.parent
HALO_TOL = 5e-3
HALOS = (8, 16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small runs gain little from more
    (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_function(name: str) -> ast.FunctionDef:
    """The JAX tool's function `name`, parsed from its source (the JAX
    tool's module configures JAX when run)."""
    tree = ast.parse((REPO / "tools" / "tiled_stereo_study.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _jax_halo(root) -> dict:
    """The JAX tool's halo measures, from the JAX package's pipeline and
    tiled wrapper on the pair under `root`, at `HALOS`."""
    import jax
    import jax.numpy as jnp

    from depth_estimation_tpu.data.datasets import TsukubaPair
    from depth_estimation_tpu.models.pipeline import (CRFStereoConfig, calibrate_capacity,
                                                      crf_stereo_infer)
    from depth_estimation_tpu.parallel.mesh import make_mesh
    from depth_estimation_tpu.parallel.stereo_tiled import crf_stereo_infer_tiled
    from depth_estimation_tpu.train.metrics import bad_pixel_ratio, epe

    item = TsukubaPair(root=str(root)).load()
    left = jnp.asarray(item["left"], jnp.float32)
    right = jnp.asarray(item["right"], jnp.float32)
    gt = jnp.asarray(item["disparity"], jnp.float32)
    mask = (gt > 0).astype(jnp.float32)
    cfg = calibrate_capacity(left, CRFStereoConfig(num_disp=16, niters=5, backend="lattice"),
                             headroom=3.0, tiled=False)
    untiled = np.asarray(crf_stereo_infer(left, right, cfg)["disparity"])
    mesh = make_mesh(data=1, tile=2)
    res = {"config": "tiled_stereo_flagship_halo", "tiles": 2,
           "untiled_epe": float(epe(jnp.asarray(untiled), gt, mask)),
           "untiled_bad2": float(bad_pixel_ratio(jnp.asarray(untiled), gt, 2.0, mask)),
           "halos": {}}
    for halo in HALOS:
        t = np.asarray(jax.jit(lambda l, r: crf_stereo_infer_tiled(l, r, cfg, mesh,
                                                                   halo=halo))(left, right))
        diff = np.abs(t[8:-8] - untiled[8:-8])
        res["halos"][halo] = {
            "max_abs_disp_delta": float(diff.max()),
            "mean_abs_disp_delta": float(diff.mean()),
            "epe": float(epe(jnp.asarray(t), gt, mask)),
            "bad2": float(bad_pixel_ratio(jnp.asarray(t), gt, 2.0, mask)),
        }
    return res


@pytest.fixture(scope="module")
def tsukuba_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tsukuba")
    left, right, gt = make_stereo_pair(np.random.RandomState(5), 96, 64, num_layers=3,
                                       max_disp=12)
    for name, img in (("imL.png", left), ("imR.png", right)):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(root / name)
    pgm = np.round(gt * 16).astype(np.uint8)
    with open(root / "truedisp.row3.col3.pgm", "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (pgm.shape[1], pgm.shape[0]) + pgm.tobytes())
    return root


@pytest.fixture(scope="module")
def halo_results(tsukuba_tree):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("DET_TSUKUBA_DIR", str(tsukuba_tree))
        mp.setattr(TS, "HALOS", HALOS)  # the tool's sweep cut to two halos
        port = TS.main(["--mode", "halo", "--device", "cpu", "--tiles", "2"])
    finally:
        mp.undo()
    return port, _jax_halo(tsukuba_tree)


def test_halo_untiled_matches_jax(halo_results):
    port, jax_res = halo_results
    assert port["config"] == jax_res["config"] and port["tiles"] == jax_res["tiles"] == 2
    for key in ("untiled_epe", "untiled_bad2"):
        assert abs(port[key] - jax_res[key]) <= HALO_TOL, key


def test_halo_reports_the_jax_tools_keys(halo_results):
    port, _ = halo_results
    top, per_halo = ({k.value for k in n.keys} for n in ast.walk(_jax_function("run_halo"))
                     if isinstance(n, ast.Dict) and n.keys)
    assert set(port) == top and list(port["halos"]) == list(HALOS)
    assert all(set(v) == per_halo for v in port["halos"].values())


@pytest.mark.parametrize("halo", HALOS)
def test_halo_deltas_match_jax(halo_results, halo):
    port, jax_res = halo_results
    got, want = port["halos"][halo], jax_res["halos"][halo]
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= HALO_TOL, (key, got[key], want[key])


def test_halo_needs_the_pair(tmp_path, monkeypatch):
    monkeypatch.setenv("DET_TSUKUBA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="DET_TSUKUBA_DIR"):
        TS.main(["--mode", "halo", "--device", "cpu"])


def _jax_time_keys() -> set[str]:
    """The keys of the dict the JAX tool's `run_time` returns, read from its
    source (running it compiles two pipelines and their timing loops)."""
    return {k.value for k in _jax_function("run_time").body[-1].value.keys}


def test_time_small_returns_the_jax_tools_keys(tmp_path):
    out = tmp_path / "time.json"
    res = TS.main(["--mode", "time", "--small", "--device", "cpu", "--reps", "2",
                   "--out", str(out)])
    assert _jax_time_keys() == {"config", "halo", "untiled_ms", "tiled_1chip_ms",
                                "overhead_pct", "unit", "device"}
    assert _jax_time_keys() <= set(res)
    assert (res["config"], res["halo"]) == ("tiled_stereo_middlebury", 16)
    assert res["unit"].startswith("ms (96x128, L=16")
    assert res["backend"] == "gloo" and res["device"] == "cpu"
    assert np.isfinite(res["untiled_ms"]) and np.isfinite(res["tiled_1chip_ms"])
    # one stripe with no halo is the frame itself
    assert res["one_tile_halo0_max_abs_disp_delta"] <= HALO_TOL
    # on the CPU the comparison with the CPU run is a repeat of the same call
    assert res["one_tile_cpu_max_abs_disp_delta"] == 0.0
    assert 0.0 <= res["cpu_one_ulp_mean_abs_disp_delta"] <= res["cpu_one_ulp_max_abs_disp_delta"]
    assert out.read_text().strip().startswith("{")
    assert not torch.distributed.is_initialized()
