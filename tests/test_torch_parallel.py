"""The PyTorch port's mesh, halo exchange and row-striped stereo pipeline on
a 4-rank `gloo` world of CPU processes, against the JAX package under
`shard_map` on 4 of the 8 virtual CPU devices.

One world is spawned for the whole file (`world` fixture); its ranks run
every rank-side check and rank 0 saves what the tests compare. The ranks
import this module, so JAX is imported inside the tests only."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models.pipeline import CRFStereoConfig
from depth_estimation_torch.ops.boxfilter import box_filter2d
from depth_estimation_torch.ops.permutohedral import simplex_embed
from depth_estimation_torch.parallel.mesh import (all_mean_, broadcast_, distributed_init,
                                                  make_mesh, shard_batch)
from depth_estimation_torch.parallel.stereo_tiled import crf_stereo_infer_tiled, stripe_guide
from depth_estimation_torch.parallel.tiling import (gather_rows, halo_exchange_rows, tiled_apply,
                                                    tiled_filter_hwc)

WORLD = 4
HALO_X = np.random.RandomState(1).randn(64, 6).astype(np.float32)
# float64: the cumsum boxes of a stripe and of the whole image cancel alike
BOX_X = np.random.RandomState(2).randn(80, 16, 2)
BOX_R = 2
# the JAX package's tiled-stereo test (tests/test_sharding.py:143-164)
CFG = CRFStereoConfig(num_disp=8, niters=3, sigma_pos=0.05)
STEREO_HALO = 16
DISP_ATOL = 5e-3  # px, over the whole image


def _pair():
    left, right, _ = make_stereo_pair(np.random.RandomState(5), h=64, w=48, max_disp=6)
    return left.astype(np.float32), right.astype(np.float32)


def _stripe(x, mesh):
    t, n = mesh.axis_index("tile"), mesh.axis_size("tile")
    lh = x.shape[0] // n
    return torch.from_numpy(x[t * lh:(t + 1) * lh])


def _box(x):
    return box_filter2d(x, BOX_R, axes=(0, 1), normalize=False)


def _ranks(rank, out_path, init_method):
    """One rank of the world: every rank-side check of this file."""
    torch.set_num_threads(1)
    assert distributed_init("gloo", init_method=init_method, world_size=WORLD, rank=rank)
    try:
        mesh = make_mesh(data=1, tile=WORLD)
        out = {"halo": gather_rows(halo_exchange_rows(_stripe(HALO_X, mesh), 3, mesh), mesh)}
        x = _stripe(BOX_X, mesh)
        out["box"] = gather_rows(tiled_apply(_box, x, BOX_R, mesh), mesh)
        out["box_hwc"] = gather_rows(
            tiled_filter_hwc(lambda s, g: _box(s * g), x, x.flip(-1), BOX_R, mesh), mesh)

        left, right = _pair()
        lp = halo_exchange_rows(_stripe(left, mesh), STEREO_HALO, mesh)
        row0 = mesh.axis_index("tile") * (left.shape[0] // WORLD) - STEREO_HALO
        out["guide"] = gather_rows(stripe_guide(lp, row0, *left.shape[:2], CFG), mesh)
        out["disparity"] = gather_rows(crf_stereo_infer_tiled(
            _stripe(left, mesh), _stripe(right, mesh), CFG, mesh, halo=STEREO_HALO,
            device="cpu"), mesh)

        # the data axis on a 2 × 2 mesh of the same world
        grid = make_mesh(data=2, tile=2)
        batch = torch.arange(8.0).reshape(4, 2)
        out["shard"] = gather_rows(shard_batch(batch, grid), grid, axis="data")
        p = torch.full((3,), float(rank))
        out["broadcast"] = gather_rows(broadcast_([p], grid)[0][None], grid, axis="tile")
        g = torch.full((2,), float(rank) ** 2)
        out["mean"] = gather_rows(all_mean_([g], grid)[0][None], grid, axis="tile")
        out["grid"] = (grid.axis_index("data"), grid.axis_index("tile"), grid.axis_ranks("data"),
                       grid.axis_ranks("tile"))
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("world")
    mp.spawn(_ranks, args=(str(d / "out.pt"), f"file://{d}/rendezvous"), nprocs=WORLD, join=True)
    return torch.load(d / "out.pt", weights_only=False)


def _jax_mesh(tile=WORLD):
    from depth_estimation_tpu.parallel.mesh import make_mesh as j_make_mesh

    return j_make_mesh(data=1, tile=tile)


def test_halo_exchange_matches_shard_map(world):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from depth_estimation_tpu.parallel.tiling import halo_exchange_rows as j_halo

    want = jax.jit(shard_map(lambda x: j_halo(x, 3, "tile"), mesh=_jax_mesh(),
                             in_specs=(P("tile"),), out_specs=P("tile"), check_vma=False))(
        jnp.asarray(HALO_X))
    assert world["halo"].shape == (64 + WORLD * 6, 6)
    np.testing.assert_array_equal(world["halo"].numpy(), np.asarray(want))


def test_tiled_box_filter_matches_global(world):
    x = torch.from_numpy(BOX_X)
    torch.testing.assert_close(world["box"], _box(x), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(world["box_hwc"], _box(x * x.flip(-1)), rtol=1e-6, atol=1e-6)


def test_stripe_guide_keys_match_jax(world):
    """The stripe guides give the same lattice keys as the JAX package's
    (`parallel/stereo_tiled.py:71-76`) under `jit`: one ulp of a guide
    value can move a vertex."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from depth_estimation_tpu.parallel.tiling import halo_exchange_rows as j_halo

    left, _ = _pair()
    h, w, _ = left.shape
    local_h, diag = h // WORLD, (h ** 2 + w ** 2) ** 0.5

    def local(left_l):
        lp = j_halo(left_l, STEREO_HALO, "tile")
        hh, ww = lp.shape[:2]
        row0 = jax.lax.axis_index("tile") * local_h - STEREO_HALO
        ii = jax.lax.broadcasted_iota(jnp.float32, (hh, ww), 0) + row0
        jj = jax.lax.broadcasted_iota(jnp.float32, (hh, ww), 1)
        pos = jnp.stack([ii, jj], -1) / diag
        return jnp.concatenate([lp / CFG.sigma_color, pos / CFG.sigma_pos], -1)

    want = np.array(jax.jit(shard_map(local, mesh=_jax_mesh(), in_specs=(P("tile"),),
                                        out_specs=P("tile"), check_vma=False))(jnp.asarray(left)))
    got = world["guide"]
    assert got.shape == want.shape == (h + 2 * WORLD * STEREO_HALO, w, 5)
    keys_t, _ = simplex_embed(got.reshape(-1, 5))
    keys_j, _ = simplex_embed(torch.from_numpy(want).reshape(-1, 5))
    assert torch.equal(keys_t, keys_j)


def test_tiled_stereo_matches_jax(world):
    import jax
    import jax.numpy as jnp

    from depth_estimation_tpu.models.pipeline import CRFStereoConfig as JCfg
    from depth_estimation_tpu.parallel.stereo_tiled import crf_stereo_infer_tiled as j_tiled

    left, right = _pair()
    jcfg = JCfg(num_disp=8, niters=3, sigma_pos=0.05)
    mesh = _jax_mesh()
    want = np.asarray(jax.jit(lambda l, r: j_tiled(l, r, jcfg, mesh, halo=STEREO_HALO))(
        jnp.asarray(left), jnp.asarray(right)))
    got = world["disparity"].numpy()
    assert got.shape == want.shape == left.shape[:2]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= DISP_ATOL, np.abs(got - want).max()


def test_data_axis_of_a_2x2_mesh(world):
    """Rank r sits at (r // 2, r % 2); each data rank takes its half of the
    batch, the broadcast comes from the data axis' rank 0 and the mean is
    over the data axis."""
    d, t, data_ranks, tile_ranks = world["grid"]
    assert (d, t, data_ranks, tile_ranks) == (0, 0, [0, 2], [0, 1])
    torch.testing.assert_close(world["shard"], torch.arange(8.0).reshape(4, 2))
    # rank 0's row of the grid: ranks 0 and 1, broadcast from ranks 0 and 1
    torch.testing.assert_close(world["broadcast"], torch.tensor([[0.0] * 3, [1.0] * 3]))
    # mean over the data axis: ranks {0, 2} and {1, 3}
    torch.testing.assert_close(world["mean"], torch.tensor([[2.0, 2.0], [5.0, 5.0]]))


def test_single_process_mesh_is_the_identity(monkeypatch):
    """Without a world, `distributed_init` joins nothing and the 1 × 1 mesh
    leaves every operation local: the halo is zeros, the shard is the
    batch, the collectives change nothing."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert distributed_init("gloo") is False
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "tile": 1} and mesh.axis_ranks("tile") == [0]
    x = torch.from_numpy(HALO_X[:8])
    padded = halo_exchange_rows(x, 2, mesh)
    assert torch.equal(padded[2:-2], x) and not padded[:2].any() and not padded[-2:].any()
    assert torch.equal(shard_batch(x, mesh), x) and gather_rows(x, mesh) is x
    p = x.clone()
    assert torch.equal(all_mean_([p], mesh)[0], x) and torch.equal(broadcast_([p], mesh)[0], x)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(data=2, tile=2)
