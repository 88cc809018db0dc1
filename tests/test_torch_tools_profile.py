"""The port's per-stage profiler (`depth_estimation_torch.tools.profile_stages`)
against the JAX system's `tools/profile_stages.py` on the CPU.

Each stage body of `make_stages` runs on the same float32 inputs as the
same stage built from the JAX package's primitives, at 32×48 with 4 labels,
untiled and with 16-px tiles: the port in float32 within 1e-5 of the
output's scale (the f32-block runs), the bf16-block run within one bf16 ulp
of the scale as tests/test_torch_lattice.py bounds it. The JAX side runs
the filter's stages and the pipeline in float64 on the float32 inputs and
plan: its splat sums a vertex as a difference of running prefix sums, and
in float32 that alone is ~1e-4 of the scale off at these 9216 entries (the
port's `index_add_` is ~2e-6 off). Vertex tables are compared through
each plan's own slots (the vertex order inside a plan may differ), and the
plan by its partition of entries into vertices. The CLI's tests are in
tests/test_torch_tools_profile_cli.py."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.tools import profile_stages as PS
from depth_estimation_tpu.crf.compat import charbonnier2, compatibility_matrix
from depth_estimation_tpu.crf.guides import stack_guide
from depth_estimation_tpu.models.pipeline import CRFStereoConfig, crf_stereo_infer
from depth_estimation_tpu.ops import permutohedral as JP
from depth_estimation_tpu.ops.costvolume import cost_volume

H, W, L, TILE = 32, 48, 4, 16
CASES = {"untiled": [], "tiled_f32": ["--tiled", "1", "--tile-px", str(TILE)],
         "tiled_bf16": ["--tiled", "2", "--tile-px", str(TILE)]}
ARGV = ["--device", "cpu", "--h", str(H), "--w", str(W), "--labels", str(L)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small runs gain little from more
    (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _jax_stages(args) -> tuple[dict, object]:
    """The JAX tool's stage outputs at acc = 0 (its setup, from the JAX
    package's primitives), and its plan."""
    rng = np.random.RandomState(0)
    left, right = _f32(rng.rand(H, W, 3)), _f32(rng.rand(H, W, 3))
    B = args.tile_px
    tile_kw = dict(tile_px=B, tile_u=512, tile_bf16=args.tiled == 2) if args.tiled else {}
    cfg0 = CRFStereoConfig(num_disp=L, niters=5, backend="lattice", **tile_kw)
    guide = stack_guide(left, cfg0.sigma_color, cfg0.sigma_pos)
    if args.tiled:
        ref = (guide.reshape(H // B, B, W // B, B, guide.shape[-1])
               .transpose(0, 2, 1, 3, 4).reshape(H * W, guide.shape[-1]))
    else:
        ref = guide.reshape(H * W, -1)
    cap = JP.suggest_capacity(ref, headroom=3.0)
    cfg = CRFStereoConfig(num_disp=L, niters=5, backend="lattice", max_vertices=cap, **tile_kw)
    build = jax.jit(partial(JP.build_plan, max_vertices=cap, pack=max(1, 128 // L),
                            order_by_sum=False, tile=B * B if args.tiled else None, tile_u=512,
                            tile_bf16=args.tiled == 2, sort_mode="auto"))
    plan = build(ref)
    # The linear stages run in float64 on the float32 inputs and plan: the
    # JAX splat sums each vertex as a difference of running prefix sums,
    # whose float32 rounding at 9216 entries is ~1e-4 of the output's scale
    plan64 = plan._replace(**{k: getattr(plan, k).astype(jnp.float64)
                              for k in ("bary", "sorted_weight", "tile_A")
                              if getattr(plan, k) is not None
                              and getattr(plan, k).dtype == jnp.float32})
    src = _f32(np.random.RandomState(1).rand(H * W, L)).astype(jnp.float64)
    vals = jax.jit(JP._splat)(plan64, src)
    blurred = jax.jit(lambda p, v: JP._blur(p, v, False))(plan64, vals)
    Mu = compatibility_matrix(lambda a, b: charbonnier2(a, b, cfg.gamma),
                              jnp.arange(L, dtype=jnp.float32))
    E0f = _f32(np.random.RandomState(2).rand(H * W, L)) * 10.0
    Q0 = jax.nn.softmax(-E0f, axis=-1)
    QMu = (Q0 @ Mu).astype(jnp.float64)

    @partial(jax.jit, static_argnums=1)
    def update(plan, filt):
        msg = JP.apply_plan(plan, QMu) if filt else QMu
        return jax.nn.softmax(-(E0f + msg - QMu), axis=-1)

    out = {
        "update": update(plan64, True),
        "elemwise": update(plan64, False),
        "embed": jax.jit(JP._simplex_embed_cols)(ref),
        "plan": plan,
        "splat": vals,
        "blur": blurred,
        "slice": jax.jit(JP._slice)(plan64, blurred),
        "apply": jax.jit(JP.apply_plan)(plan64, src),
        "costvolume": jax.jit(cost_volume, static_argnums=(2, 3))(left, right, L,
                                                                  cfg.window_size),
        # the pipeline from the same pair in float64, for the same reason
        "pipeline": jax.jit(lambda l, r: crf_stereo_infer(l, r, cfg)["disparity"])(
            left.astype(jnp.float64), right.astype(jnp.float64)),
    }
    return out, cfg


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    args = PS.parse_args(ARGV + CASES[request.param])
    inputs, keys = PS.prepare(args, torch.device("cpu"))
    zero = torch.zeros(())
    with torch.no_grad():
        port = {name: fn(zero) for name, fn in PS.make_stages(inputs).items()}
    jax_out, jax_cfg = _jax_stages(args)
    return request.param, port, jax_out, inputs, jax_cfg, keys


def _canonical(labels: np.ndarray) -> np.ndarray:
    """Labels renumbered by first appearance (a partition, whatever the
    numbering)."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)].reshape(labels.shape)


def _close(case: str, got, want) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if case == "tiled_bf16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8 * scale)
        assert np.mean(np.abs(got - want) <= 1e-5 * scale) > 0.95
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def _by_entry(vals, slot) -> np.ndarray:
    """A vertex table (C+1, L) read at each pixel's d+1 vertices: (n, d+1, L),
    independent of the vertex order."""
    return np.asarray(vals)[np.asarray(slot)]


def test_configuration_matches_the_jax_tool(both):
    case, _, _, inputs, jax_cfg, keys = both
    assert inputs.cfg.max_vertices == jax_cfg.max_vertices == keys["capacity"]
    assert keys["tiled"] == (0 if case == "untiled" else int(case == "tiled_bf16") + 1)
    assert (inputs.cfg.tile_px, inputs.cfg.tile_u, inputs.cfg.tile_bf16) == (
        jax_cfg.tile_px, jax_cfg.tile_u, jax_cfg.tile_bf16)


@pytest.mark.parametrize("stage", ["update", "elemwise", "slice", "apply", "costvolume"])
def test_pixel_stages_match_jax(both, stage):
    case, port, jax_out, *_ = both
    _close(case, port[stage].numpy(), jax_out[stage])


def test_embed_matches_jax(both):
    case, port, jax_out, *_ = both
    (kp, bp), (kj, bj) = port["embed"], jax_out["embed"]
    assert len(kp) == len(kj)
    for a, b in zip(kp, kj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close("f32", bp.numpy(), bj)


def test_plan_matches_jax(both):
    """The same entries share a vertex in both plans (the slots as a
    partition), with the same weights, occupancy, overflow and blur
    neighbours (renumbered alike)."""
    _, port, jax_out, *_ = both
    pp, pj = port["plan"], jax_out["plan"]
    assert int(pp.num_valid) == int(pj.num_valid)
    if pp.tile_A is not None:
        assert int(pp.tile_overflow) == int(pj.tile_overflow)
        assert pp.tile_A.shape == pj.tile_A.shape
    sp, sj = pp.slot.numpy(), np.asarray(pj.slot)
    np.testing.assert_array_equal(_canonical(sp), _canonical(sj))
    _close("f32", pp.bary.numpy(), pj.bary)
    # neighbours of each pixel's vertices, through each plan's numbering
    C = pp.capacity
    for j in range(pp.neighbors.shape[0]):
        for side in range(2):
            np_ = pp.neighbors[j, :, side].numpy()[sp]
            nj = np.asarray(pj.neighbors)[j, :, side][sj]
            assert np.array_equal(np_ == C, nj == C)
            hit = np_ != C
            relabel = dict(zip(sp.reshape(-1), sj.reshape(-1)))
            assert all(relabel.get(a, -1) == b for a, b in zip(np_[hit], nj[hit]))


@pytest.mark.parametrize("stage", ["splat", "blur"])
def test_vertex_stages_match_jax(both, stage):
    case, port, jax_out, *_ = both
    got = _by_entry(port[stage].numpy(), port["plan"].slot.numpy())
    want = _by_entry(jax_out[stage], jax_out["plan"].slot)
    _close(case, got, want)


def test_pipeline_matches_jax(both):
    case, port, jax_out, *_ = both
    _close(case, port["pipeline"].numpy(), jax_out["pipeline"])
