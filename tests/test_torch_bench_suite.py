"""The port's benchmark suite (`depth_estimation_torch.tools.bench_suite`)
against the JAX system's `tools/bench_suite.py` on the CPU.

Each configuration runs through `main` with `--small` and prints the JAX
suite's keys in the JAX suite's order (read from the dict literals that its
`run_config` returns), then the port's own: the fused-update kernels'
launches per call (none on the CPU, where the fused update takes its plain
version), the plan's occupancy and the TF32 setting. The small shapes are
cut further here (`TINY`: the flagship pair at 8×16, the two large frames
at 32×64 with 8 labels), since the JAX suite's small training step takes
about 25 s a step on one CPU thread. The lattice configurations of
middlebury64 and fullres128 are calibrated as the JAX suite's own
`_lattice_cfg` calibrates them on the same pair (its `_natural_pair`, at
the JAX suite's small shapes), and one step of the training configuration
(`trainable_plan`, `trainable_loss`, `torch.optim.Adam`) matches one optax
Adam step of the JAX package from the same parameters, carried across by
`load_jax_params`: the loss to 1e-4 and every parameter to 1e-5."""
import ast
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models.pipeline import CRFStereoConfig, stereo_unary
from depth_estimation_torch.models.refiner import CRFasRNN
from depth_estimation_torch.ops.cuda import meanfield as K
from depth_estimation_torch.tools import bench_suite as S
from depth_estimation_torch.utils.weights import load_jax_params

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = {"flagship": (8, 16), "middlebury64": (32, 64, 8), "fullres128": (32, 64, 8), "batch": 2}
# the port's keys after the JAX suite's, by config
EXTRA = {"tsukuba_dense": {"launches_per_call", "allow_tf32"},
         "middlebury64": {"launches_per_call", "num_valid", "tile_overflow"},
         "trainable_step": {"launches_per_call"},
         "fullres128": {"launches_per_call", "num_valid", "tile_overflow"},
         "serving_batched": {"launches_per_call"}}
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small runs gain little from more
    (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_suite_source() -> ast.Module:
    return ast.parse((REPO / "tools" / "bench_suite.py").read_text())


def _jax_keys() -> dict[str, list[str]]:
    """{config: its line's keys in order}, from the dict literal returned
    under each `if name == ...:` of the JAX suite's `run_config`."""
    fn = next(n for n in _jax_suite_source().body
              if isinstance(n, ast.FunctionDef) and n.name == "run_config")
    keys = {}
    for node in fn.body:
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare):
            ret = next(n for n in ast.walk(node)
                       if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
            keys[node.test.comparators[0].value] = [k.value for k in ret.value.keys]
    return keys


def _jax_suite():
    """The JAX suite's module, loaded from its file (its functions import
    the JAX package when called)."""
    spec = importlib.util.spec_from_file_location("jax_bench_suite",
                                                  REPO / "tools" / "bench_suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_configs_are_the_jax_suites():
    tree = _jax_suite_source()
    names = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "ALL_CONFIGS")
    assert S.CONFIGS == tuple(ast.literal_eval(names))
    assert list(_jax_keys()) == list(S.CONFIGS)
    assert S._config_names("2,fullres128,1") == ["middlebury64", "fullres128", "tsukuba_dense"]
    assert S._config_names(None) == list(S.CONFIGS)
    with pytest.raises(ValueError, match="unknown config"):
        S._config_names("7")


@pytest.mark.parametrize("name", S.CONFIGS)
def test_each_config_prints_the_jax_keys(name, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(S, "SMALL", TINY)
    out = tmp_path / "lines.jsonl"
    lines = S.main(["--device", "cpu", "--small", "--reps", "2", "--configs", name,
                    "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [printed] == lines == [json.loads(x) for x in out.read_text().splitlines()]
    keys = _jax_keys()[name]
    assert list(printed)[:len(keys)] == keys
    assert set(printed) - set(keys) == EXTRA[name]
    assert printed["config"] == name and printed["device"] == "cpu"
    assert np.isfinite(printed["value"]) and printed["value"] > 0
    assert printed["launches_per_call"] == {k: 0 for k in K.KERNELS}
    if "num_valid" in printed:
        assert 0 < printed["num_valid"] <= printed["max_vertices"]
        assert not printed["tile_overflow"]
        assert printed["source"] == "synthetic_layers"
    if name == "tsukuba_dense":
        h, w = TINY["flagship"]
        assert (printed["h"], printed["w"], printed["labels"], printed["niters"]) == (h, w, 16, 5)
        assert printed["allow_tf32"] is False
    if name == "serving_batched":
        assert printed["value"] == max(printed["loop_fps"], printed["vmap_fps"])
        assert "'vmap' runs the per-frame program" in printed["unit"]


def test_lattice_configs_calibrate_as_the_jax_suite():
    """middlebury64 and fullres128 at the JAX suite's small shapes: the
    same natural pair as its `_natural_pair`, and the port's calibrated
    configuration that of its `_lattice_cfg` (capacity, tiles, tile_u, sort
    mode, bf16 blocks), in the bench's bf16 fused state. (At these shapes
    the two configurations' pairs are the same, so the JAX side runs
    once.)"""
    import jax.numpy as jnp

    from depth_estimation_tpu.models.pipeline import CRFStereoConfig as JCfg

    jax_suite = _jax_suite()
    fields = ("num_disp", "niters", "max_vertices", "tile_px", "tile_u", "sort_mode",
              "tile_bf16")
    jax_cfgs = {}
    for name, max_disp in (("middlebury64", lambda L: L - 2),
                           ("fullres128", lambda L: min(L - 2, 96))):
        h, w, L = S.SMALL[name]
        key = (h, w, L, max_disp(L))
        left, right, source = S.natural_pair(h, w, max_disp(L), "cpu")
        if key not in jax_cfgs:
            jleft, jright, jsource = jax_suite._natural_pair(None, h, w, max_disp(L))
            jcfg = jax_suite._lattice_cfg(JCfg(num_disp=L, niters=5, backend="lattice"),
                                          jnp.asarray(jleft))
            jax_cfgs[key] = (np.asarray(jleft), np.asarray(jright), jsource,
                             {k: getattr(jcfg, k) for k in fields})
        jleft, jright, jsource, jcfg = jax_cfgs[key]
        assert source == jsource == "synthetic_layers"
        np.testing.assert_array_equal(left.numpy(), jleft)
        np.testing.assert_array_equal(right.numpy(), jright)
        cfg = S.lattice_cfg(L, left, "cpu")
        assert {k: getattr(cfg, k) for k in fields} == jcfg, name
        assert cfg.tile_px == S.TILE_PX
        assert (cfg.compute_dtype, cfg.fused_update) == ("bf16", True)


def test_trainable_step_matches_one_optax_step():
    """One Adam step of the training configuration at 24×32 on a synthetic
    pair (untiled, as the JAX suite's small step): the JAX side is the
    JAX suite's `loss_fn` (its `trainable_step`), from `crf_rnn_init`'s
    parameters, which the port's `CRFasRNN` takes by `load_jax_params`."""
    import jax
    import jax.numpy as jnp
    import optax

    from depth_estimation_tpu.crf.guides import ijrgb_guide
    from depth_estimation_tpu.models.pipeline import CRFStereoConfig as JCfg
    from depth_estimation_tpu.models.pipeline import stereo_unary as j_stereo_unary
    from depth_estimation_tpu.models.refiner import crf_rnn_apply, crf_rnn_init
    from depth_estimation_tpu.ops.permutohedral import suggest_capacity

    h, w, L = 24, 32, 16
    left, right, _ = (x.astype(np.float32) for x in
                      make_stereo_pair(np.random.RandomState(4), h, w, max_disp=6))
    jleft = jnp.asarray(left)
    E0 = j_stereo_unary(jleft, jnp.asarray(right), JCfg(num_disp=L, niters=5))
    params = crf_rnn_init(backend="lattice")
    g0 = ijrgb_guide(params["w"], jleft)
    cap = suggest_capacity(g0.reshape(-1, g0.shape[-1]), headroom=8.0)

    def loss_fn(p):
        logits = crf_rnn_apply(p, jleft, -E0, niters=5, backend="lattice", max_vertices=cap)
        disp = (jax.nn.softmax(logits, -1) @ jnp.arange(L, dtype=jnp.float32)).reshape(h, w)
        return jnp.sum((disp - 0.0) ** 2) / (h * w)

    opt = optax.adam(3e-2)
    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    up, _ = opt.update(g, opt.init(params))
    new_j = optax.apply_updates(params, up)

    tleft, tright = torch.from_numpy(left), torch.from_numpy(right)
    plan = S.trainable_plan(tleft, tiled=False)
    assert plan == {"max_vertices": cap}
    model = CRFasRNN(backend="lattice", device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params), device="cpu")
    topt = torch.optim.Adam(model.parameters(), lr=3e-2)
    logits = -stereo_unary(tleft, tright, CRFStereoConfig(num_disp=L))
    loss_t = S.trainable_loss(model, tleft, logits, torch.zeros(h, w), torch.ones(h, w), 5, plan)
    loss_t.backward()
    topt.step()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=STEP_LOSS_RTOL)
    want = {"mu.gamma": new_j["mu"]["gamma"], "mu.log_s": new_j["mu"]["log_s"],
            **{f"w.{k}": v for k, v in new_j["w"].items()}}
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        moved = p.detach().numpy() - np.asarray(jax.tree.map(np.asarray, params)[
            name.split(".")[0]][name.split(".")[1]])
        assert np.abs(moved).max() > 1e-3, name  # each parameter took its step
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=0,
                                   atol=STEP_PARAM_ATOL, err_msg=name)
