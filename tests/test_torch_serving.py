"""The PyTorch port's `StereoServer` against the JAX package's on the 8
frames of `tests/test_serving.py`: the same calibration from the first
frame, the same disparities, vmap mode equal to loop mode, and a 2-rank
`gloo` data mesh (spawned CPU processes) equal to the plain server.

The ranks import this module, so JAX is imported inside the tests only."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models.pipeline import CRFStereoConfig
from depth_estimation_torch.models.serving import StereoServer
from depth_estimation_torch.parallel.mesh import distributed_init, make_mesh

CFG = dict(num_disp=8, niters=2)
CALIBRATED = ("max_vertices", "sort_mode", "tile_px", "tile_u", "max_pieces")
DISP_ATOL = 5e-3  # px
DATA = 2


def _batch():
    lefts, rights = [], []
    for i in range(8):
        left, right, _ = make_stereo_pair(np.random.RandomState(i), h=32, w=48, max_disp=6)
        lefts.append(left)
        rights.append(right)
    return np.stack(lefts).astype(np.float32), np.stack(rights).astype(np.float32)


def _ranks(rank, out_path, init_method):
    torch.set_num_threads(1)
    assert distributed_init("gloo", init_method=init_method, world_size=DATA, rank=rank)
    try:
        server = StereoServer(CRFStereoConfig(**CFG), mesh=make_mesh(data=DATA), device="cpu")
        lefts, rights = _batch()
        out = {"disparity": server(lefts, rights), "cfg": server.cfg,
               "stats": server.throughput(lefts[:DATA], rights[:DATA], reps=2)}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def plain(batch):
    server = StereoServer(CRFStereoConfig(**CFG), device="cpu")
    return server, server(*batch)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("world")
    mp.spawn(_ranks, args=(str(d / "out.pt"), f"file://{d}/rendezvous"), nprocs=DATA, join=True)
    return torch.load(d / "out.pt", weights_only=False)


def test_server_matches_the_jax_server(batch, plain):
    from depth_estimation_tpu.models.pipeline import CRFStereoConfig as JCfg
    from depth_estimation_tpu.models.serving import StereoServer as JServer

    lefts, rights = batch
    jserver = JServer(JCfg(**CFG))
    want = np.asarray(jserver(lefts, rights))
    server, got = plain
    assert got.shape == want.shape == (8, 32, 48) and got.device.type == "cpu"
    for f in CALIBRATED:
        assert getattr(server.cfg, f) == getattr(jserver.cfg, f), f
    assert server.cfg.max_vertices is not None and server.cfg.tile_px == 32
    assert np.abs(got.numpy() - want).max() <= DISP_ATOL, np.abs(got.numpy() - want).max()


def test_vmap_mode_matches_loop_mode(batch, plain):
    server, loop = plain
    vmapped = StereoServer(server.cfg, batch_mode="vmap", auto_capacity=False, device="cpu")
    assert torch.equal(vmapped(*batch), loop)
    with pytest.raises(ValueError, match="batch_mode"):
        StereoServer(server.cfg, batch_mode="scan", device="cpu")


def test_data_mesh_matches_the_plain_server(world, plain):
    server, loop = plain
    assert dataclasses.asdict(world["cfg"]) == dataclasses.asdict(server.cfg)
    assert world["disparity"].shape == (8, 32, 48)
    torch.testing.assert_close(world["disparity"], loop, rtol=0, atol=1e-6)


def test_throughput_reports_its_keys(world, batch, plain):
    stats = world["stats"]
    assert set(stats) == {"frames_per_s", "batch", "ms_per_batch", "devices"}
    assert stats["devices"] == DATA and stats["batch"] == DATA
    assert stats["frames_per_s"] > 0 or np.isnan(stats["frames_per_s"])
    one = plain[0].throughput(batch[0][:1], batch[1][:1], reps=2)
    assert one["devices"] == 1 and one["batch"] == 1
    assert one["ms_per_batch"] > 0 or np.isnan(one["ms_per_batch"])
