"""The PyTorch port's batched detection training and evaluation against the
JAX package, and their data-parallel path on a 2-rank `gloo` world.

`train_detection_shapes_batched` (two steps on batches of two shapes
images, then `evaluate_detection`) runs unsharded in both packages from
the same flax init in float64 (JAX with x64 on; the JAX function draws its
own float32 init, which the test casts to float64 as it is drawn). One
world of 2 CPU processes is spawned for the file (`world` fixture): each
rank runs the same call with `mesh=make_mesh(data=2)`, one image of every
batch a rank, and rank 0 saves its history and parameters. The ranks
import this module, so JAX is imported inside the tests only."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from depth_estimation_torch.models.detection.rcnn import MaskRCNN
from depth_estimation_torch.parallel.mesh import distributed_init, make_mesh
from depth_estimation_torch.train import experiments as TE

DATA = 2
RUN = dict(num_steps=2, batch_size=2, num_items=2, h=64, eval_at_end=True)
KW = dict(num_classes=4, blocks=(1, 1, 1, 1), fpn_dim=32, num_proposals=32, num_detections=8,
          score_thresh=-1.0)
EVAL_KEYS = ("map50", "map", "coco_map", "coco_map50")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small float64 runs gain little from
    more (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_run(init_path, mesh=None):
    init = torch.load(init_path, weights_only=True)
    return TE.train_detection_shapes_batched(**RUN, mesh=mesh, init_params=init,
                                             device="cpu")


def _ranks(rank, init_path, out_path, init_method):
    torch.set_num_threads(1)
    assert distributed_init("gloo", init_method=init_method, world_size=DATA, rank=rank)
    try:
        model, hist = _port_run(init_path, make_mesh(data=DATA))
        if rank == 0:
            torch.save({"hist": hist, "state": model.state_dict()}, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, the port's unsharded run and the 2-rank world's run."""
    import jax
    from flax import linen as nn

    from depth_estimation_tpu.models.detection.rcnn import MaskRCNN as JMaskRCNN
    from depth_estimation_tpu.train import experiments as JE
    from depth_estimation_torch.utils.weights import state_dict_from_jax

    d = tmp_path_factory.mktemp("detect_world")
    drawn = {}

    def init_f64(self, *args, **kwargs):
        drawn["p0"] = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                   nn.Module.init(self, *args, **kwargs))
        return drawn["p0"]

    mp_ = pytest.MonkeyPatch()
    mp_.setattr(JMaskRCNN, "init", init_f64)
    try:
        _, jhist = JE.train_detection_shapes_batched(**RUN, model_kwargs=None)
    finally:
        mp_.undo()
    init = state_dict_from_jax(MaskRCNN(**KW, device="cpu").double(), drawn["p0"])
    torch.save(init, d / "init.pt")
    model, hist = _port_run(d / "init.pt")
    mp.spawn(_ranks, args=(str(d / "init.pt"), str(d / "out.pt"), f"file://{d}/rendezvous"),
             nprocs=DATA, join=True)
    world = torch.load(d / "out.pt", weights_only=False)
    return {"jax": jhist, "port": (model, hist), "world": world}


def test_batched_training_matches_jax(runs):
    jhist, (_, hist) = runs["jax"], runs["port"]
    # the RPN box targets are float32 encodes in both packages (their log
    # rounds per library); everything else is float64
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-7)
    assert len(hist["loss"]) == RUN["num_steps"] and len(hist["step_seconds"]) == RUN["num_steps"]


def test_evaluate_detection_matches_jax(runs):
    jhist, (_, hist) = runs["jax"], runs["port"]
    for k in EVAL_KEYS:
        assert hist[k] == pytest.approx(jhist[k], abs=1e-12), k


def test_data_parallel_run_matches_the_unsharded_one(runs):
    """Each rank's half batch, gradients averaged over the ranks: the same
    steps as the full batch, and the gathered evaluation sees every item."""
    (model, hist), world = runs["port"], runs["world"]
    np.testing.assert_allclose(world["hist"]["loss"], hist["loss"], rtol=1e-12)
    for k, v in model.state_dict().items():
        # Adam's first steps are ±lr wherever |g| ≫ eps: a gradient summed in
        # another order moves a parameter by at most rounding
        np.testing.assert_allclose(world["state"][k].numpy(), v.numpy(), rtol=1e-9, atol=1e-10,
                                   err_msg=k)
    for k in EVAL_KEYS:
        assert world["hist"][k] == pytest.approx(hist[k], abs=1e-12), k
