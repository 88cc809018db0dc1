"""The PyTorch port's training path against the JAX package on the CPU:
`TrainableDenseCRF` takes the same Adam steps as the JAX package's optax
loop from carried-across params, the experiments train, the `Trainer`
fits and checkpoints like the JAX one, its data-parallel step on a 2-rank
`gloo` world of spawned CPU processes matches the full batch and the JAX
`Trainer` on an 8-device mesh, `cosine_lr` equals optax's schedule, and
`apps.train_crf` runs with --device cpu.

The ranks import this module, so JAX is imported inside the tests only."""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from depth_estimation_torch.apps import train_crf
from depth_estimation_torch.crf.guides import pixel_coords
from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.ops.costvolume import cost_volume, expected_disparity
from depth_estimation_torch.parallel.mesh import distributed_init, make_mesh
from depth_estimation_torch.parallel.tiling import gather_rows
from depth_estimation_torch.train import experiments as TE
from depth_estimation_torch.train.metrics import masked_mse
from depth_estimation_torch.ops.permutohedral import simplex_embed
from depth_estimation_torch.train.trainer import Trainer, cosine_lr
from depth_estimation_torch.utils.weights import load_jax_params

STEP_RTOL = 1e-4  # loss and every parameter, after each Adam step
DATA = 2  # ranks of the data-parallel world


def _pair(h=40, w=60, seed=0):
    left, right, disp = make_stereo_pair(np.random.RandomState(seed), h, w, max_disp=6)
    return left.astype(np.float32), right.astype(np.float32), (disp + 1e-3).astype(np.float32)


@pytest.mark.parametrize("dt,param_rtol", [(np.float64, STEP_RTOL), (np.float32, 1e-3)])
def test_trainable_crf_adam_steps_match_optax(dt, param_rtol):
    """In float64 the loss and every parameter agree to 1e-4 after each
    step. In float32 the loss does too; the parameters are held to 1e-3:
    ∂ref is a difference of large filtered terms, and Adam divides each
    gradient by its own running scale, so the proj_b step (a sum of ∂ref
    over all pixels) carries a ~1e-3 relative float32 error. The guides'
    lattice keys are the same in both packages before every step."""
    import jax
    import jax.numpy as jnp
    import optax

    from depth_estimation_tpu.crf.guides import pixel_coords as j_pixel_coords
    from depth_estimation_tpu.models.features import random_features
    from depth_estimation_tpu.ops.costvolume import cost_volume as j_cost_volume
    from depth_estimation_tpu.ops.costvolume import expected_disparity as j_expected_disparity
    from depth_estimation_tpu.train import experiments as JE
    from depth_estimation_tpu.train.metrics import masked_mse as j_masked_mse

    left, right, gt = (x.astype(dt) for x in _pair(24, 32))
    L, niters = 8, 2
    jdt = jnp.float64 if dt == np.float64 else jnp.float32
    feats = np.array(jax.jit(lambda x: random_features(x, out_dim=8))(jnp.asarray(left)))
    jp = JE.trainable_crf_init(jax.random.PRNGKey(0), d_feat=8, dtype=jdt)
    logits_j = -j_cost_volume(jnp.asarray(left), jnp.asarray(right), L, 9)
    gt_j = jnp.asarray(gt)

    def jloss(p):
        disp = j_expected_disparity(JE.trainable_crf_forward(p, logits_j, jnp.asarray(left),
                                                             jnp.asarray(feats), niters))
        return j_masked_mse(disp, gt_j, (gt_j > 0).astype(jdt))

    opt = optax.adam(3e-2)

    @jax.jit
    def jstep(p, s):
        loss, g = jax.value_and_grad(jloss)(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss

    model = TE.TrainableDenseCRF(d_feat=8, dtype=torch.float64 if dt == np.float64 else
                                 torch.float32, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jp), device="cpu")
    topt = torch.optim.Adam(model.parameters(), lr=3e-2)
    logits_t = -cost_volume(torch.from_numpy(left), torch.from_numpy(right), L, 9)
    gt_t = torch.from_numpy(gt)
    s = opt.init(jp)
    jguide = jax.jit(lambda p: jnp.concatenate([
        j_pixel_coords(24, 32, jdt) / jnp.exp(p["log_s_ij"]),
        jnp.asarray(left) / jnp.exp(p["log_s_rgb"]),
        (jnp.asarray(feats) @ p["proj_w"] + p["proj_b"]) / jnp.exp(p["log_s_feat"])], -1))
    for _ in range(3):
        with torch.no_grad():
            g_t = torch.cat([pixel_coords(24, 32, model.proj_w.dtype) / torch.exp(model.log_s_ij),
                             torch.from_numpy(left) / torch.exp(model.log_s_rgb),
                             (torch.from_numpy(feats) @ model.proj_w + model.proj_b)
                             / torch.exp(model.log_s_feat)], -1)
        keys_t, _ = simplex_embed(g_t.reshape(-1, 8))
        keys_j, _ = simplex_embed(torch.from_numpy(np.array(jguide(jp))).reshape(-1, 8))
        assert torch.equal(keys_t, keys_j)
        jp, s, loss_j = jstep(jp, s)
        topt.zero_grad()
        loss_t = masked_mse(expected_disparity(model(logits_t, torch.from_numpy(left),
                                                     torch.from_numpy(feats), niters)),
                            gt_t, (gt_t > 0).to(gt_t.dtype))
        loss_t.backward()
        topt.step()
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=STEP_RTOL)
        flat = {"proj_w": jp["proj_w"], "proj_b": jp["proj_b"], "log_s_ij": jp["log_s_ij"],
                "log_s_rgb": jp["log_s_rgb"], "log_s_feat": jp["log_s_feat"],
                "mu.gamma": jp["mu"]["gamma"], "mu.log_s": jp["mu"]["log_s"]}
        for name, p in model.named_parameters():
            want = np.asarray(flat[name])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=param_rtol * max(np.abs(want).max(), 1e-3),
                                       err_msg=name)


def test_train_tsukuba_crf_reduces_the_masked_mse():
    """25 Adam steps on a 40×60 synthetic pair, as the JAX package's test."""
    left, right, gt = _pair()
    model, hist = TE.train_tsukuba_crf(left, right, gt, num_steps=25, lr=3e-2, num_disp=8,
                                       niters=2, d_feat=8, device="cpu")
    assert np.isfinite(hist["loss"]).all() and len(hist["step_seconds"]) == 25
    assert hist["mse_after"] < hist["mse_before"], hist
    assert abs(model.log_s_ij.item() - np.log(0.1)) > 1e-4


@pytest.mark.parametrize("guidance", ["cnn", "vgg"])
def test_train_tsukuba_crf_other_guidance(guidance):
    left, right, gt = _pair(16, 24)
    if guidance == "vgg":
        with pytest.warns(UserWarning, match="RANDOM-init"):
            model, hist = TE.train_tsukuba_crf(left, right, gt, num_steps=2, num_disp=4,
                                               niters=1, d_feat=4, guidance="vgg", device="cpu")
    else:
        model, hist = TE.train_tsukuba_crf(left, right, gt, num_steps=2, num_disp=4, niters=1,
                                           d_feat=4, guidance="cnn", device="cpu")
        assert any(k.startswith("cnn.") for k, _ in model.named_parameters())
    assert np.isfinite(hist["loss"]).all() and np.isfinite(hist["mse_after"])


def test_train_upsampler_matches_jax():
    """The upsampler draws nothing at random, so the two packages start
    from the same parameters and must take the same steps (1e-3: the
    float32 guided filter, tests/test_torch_refiner.py)."""
    from depth_estimation_tpu.train import experiments as JE

    rs = np.random.RandomState(1)
    h, w = 32, 48
    disp = np.full((h, w), 2.0, np.float32)
    disp[:, w // 2:] = 8.0
    img = rs.rand(h, w, 3).astype(np.float32)
    img[:, w // 2:, 2] += 0.8
    items = [{"disp_lowres": disp[::4, ::4], "image": img, "disparity": disp}]
    _, hj = JE.train_upsampler(items, num_steps=3, niters=1, r=3)
    _, ht = TE.train_upsampler(items, num_steps=3, niters=1, r=3, device="cpu")
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-3)
    np.testing.assert_allclose(ht["l1_after"], hj["l1_after"], rtol=1e-3)


def test_train_uncertainty_runs():
    left, right, gt = _pair(16, 24)
    items = [{"left": left, "right": right, "disparity": gt}]
    for weighted in (False, True):
        _, hist = TE.train_uncertainty(items, num_steps=3, niters=1, r=3, num_disp=4, d_feat=8,
                                       unc_weighted=weighted, device="cpu")
        assert np.isfinite(hist["loss"]).all() and np.isfinite(hist["l1_after"])


def test_trainer_fits_like_the_jax_trainer(tmp_path):
    import jax.numpy as jnp
    import optax

    from depth_estimation_tpu.train import trainer as JT

    for k in ("jax", "torch"):
        (tmp_path / k).mkdir()
    rng = np.random.RandomState(0)
    X = rng.randn(128, 3).astype(np.float32)
    y = X @ np.array([2.0, -1.0, 0.5], np.float32)
    jt = JT.Trainer(lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2), optax.adam(0.1),
                    log_dir=str(tmp_path / "jax"), log_every=5)
    js = jt.fit(jt.init({"w": jnp.zeros(3, jnp.float32)}), [(jnp.asarray(X), jnp.asarray(y))], 100)

    model = torch.nn.Linear(3, 1, bias=False)
    torch.nn.init.zeros_(model.weight)
    tt = Trainer(lambda m, b: ((m(b[0])[:, 0] - b[1]) ** 2).mean(),
                 lambda ps: torch.optim.Adam(ps, lr=0.1), log_dir=str(tmp_path / "torch"),
                 log_every=5, device="cpu")
    ts = tt.fit(tt.init(model), [(torch.from_numpy(X), torch.from_numpy(y))], 100)
    np.testing.assert_allclose(model.weight.detach().numpy()[0], np.asarray(js.params["w"]),
                               rtol=1e-4, atol=1e-5)
    assert ts.step == int(js.step) == 100
    logs = [[json.loads(x) for x in (tmp_path / k / "train_log.jsonl").read_text().splitlines()]
            for k in ("jax", "torch")]
    assert [sorted(r) for r in logs[0]] == [sorted(r) for r in logs[1]]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]


def test_trainer_checkpoint_roundtrip_and_eval(tmp_path):
    model = torch.nn.Linear(2, 1)
    tr = Trainer(lambda m, b: (m.weight ** 2).sum(), lambda ps: torch.optim.Adam(ps, lr=0.01),
                 metrics_fn=lambda m, b: {"w2": (m.weight ** 2).sum()}, log_dir=str(tmp_path),
                 lr_schedule=cosine_lr(0.01, 3), device="cpu")
    state = tr.fit(tr.init(model), [None], num_steps=3, eval_batches=[None], eval_every=3)
    tr.save(state)
    fresh = tr.init(torch.nn.Linear(2, 1))
    restored = tr.restore(fresh)
    assert restored.step == 3
    assert torch.equal(restored.model.weight, model.weight)
    assert restored.optimizer.state_dict()["state"][0]["step"] == 3
    log = (tmp_path / "train_log.jsonl").read_text().splitlines()
    assert any("eval" in json.loads(x) for x in log)


# --- data parallelism: a 2-rank world, spawned once for the file -----------

MLP_X = np.random.RandomState(3).randn(32, 4)  # float64: the grads agree to 1e-6
MLP_Y = np.random.RandomState(4).randn(32)
LSQ_X = np.random.RandomState(0).randn(32, 3).astype(np.float32)
LSQ_Y = LSQ_X @ np.array([2.0, -1.0, 0.5], np.float32)


def _mlp(seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 1)).double()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype))
    return model


def _sq_loss(m, b):
    return ((m(b[0])[:, 0] - b[1]) ** 2).mean()


def _lsq_trainer(log_dir, mesh=None) -> Trainer:
    return Trainer(_sq_loss, lambda ps: torch.optim.Adam(ps, lr=0.1),
                   metrics_fn=lambda m, b: {"mse": _sq_loss(m, b)}, log_dir=str(log_dir),
                   log_every=1, mesh=mesh, device="cpu")


def _zeros_linear() -> torch.nn.Module:
    model = torch.nn.Linear(3, 1, bias=False)
    torch.nn.init.zeros_(model.weight)
    return model


def _ranks(rank, out_dir, init_method):
    torch.set_num_threads(1)
    assert distributed_init("gloo", init_method=init_method, world_size=DATA, rank=rank)
    try:
        mesh = make_mesh(data=DATA)
        out = {}
        # every rank starts from other parameters: init broadcasts rank 0's
        tr = Trainer(_sq_loss, lambda ps: torch.optim.SGD(ps, lr=0.0), mesh=mesh, device="cpu")
        state = tr.init(_mlp(seed=rank))
        out["mlp_init"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        tr.fit(state, [(torch.from_numpy(MLP_X), torch.from_numpy(MLP_Y))], 1)
        out["mlp_grads"] = [p.grad.clone() for p in state.model.parameters()]

        tr = _lsq_trainer(f"{out_dir}/log", mesh)
        model = _zeros_linear()
        batch = (torch.from_numpy(LSQ_X), torch.from_numpy(LSQ_Y))
        state = tr.fit(tr.init(model), [batch], 1, eval_batches=[batch], eval_every=1)
        out["w"] = model.weight.detach().clone()
        out["w_every_rank"] = gather_rows(out["w"], mesh, axis="data")
        tr.save(state)
        restored = tr.restore(tr.init(_zeros_linear()))
        out["restored"] = gather_rows(restored.model.weight.detach(), mesh, axis="data")
        out["restored_step"] = restored.step
        if rank == 0:
            torch.save(out, f"{out_dir}/out.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("world")
    mp.spawn(_ranks, args=(str(d), f"file://{d}/rendezvous"), nprocs=DATA, join=True)
    return d, torch.load(d / "out.pt", weights_only=False)


def test_data_parallel_gradients_match_the_full_batch(world):
    """The all-reduced gradients of the two shards are the single-process
    gradients of the whole batch, from rank 0's parameters."""
    _, out = world
    model = _mlp(seed=0)
    for k, v in model.state_dict().items():
        assert torch.equal(out["mlp_init"][k], v), k
    assert not torch.equal(_mlp(seed=1)[0].weight, model[0].weight)
    _sq_loss(model, (torch.from_numpy(MLP_X), torch.from_numpy(MLP_Y))).backward()
    for got, p in zip(out["mlp_grads"], model.parameters()):
        torch.testing.assert_close(got, p.grad, rtol=1e-6, atol=1e-12)


def test_data_parallel_step_matches_the_jax_trainer(world, tmp_path):
    """One Adam step of least squares: the 2-rank port against the JAX
    `Trainer` on an 8-device data mesh, on the logged loss, the evaluation
    and the parameters; rank 0 alone wrote the log."""
    import jax.numpy as jnp
    import optax

    from depth_estimation_tpu.parallel.mesh import make_mesh as j_make_mesh
    from depth_estimation_tpu.train import trainer as JT

    d, out = world
    jt = JT.Trainer(lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2), optax.adam(0.1),
                    metrics_fn=lambda p, b: {"mse": jnp.mean((b[0] @ p["w"] - b[1]) ** 2)},
                    log_dir=str(tmp_path), log_every=1, mesh=j_make_mesh(data=8))
    batch = (jnp.asarray(LSQ_X), jnp.asarray(LSQ_Y))
    js = jt.fit(jt.init({"w": jnp.zeros(3, jnp.float32)}), [batch], 1, eval_batches=[batch],
                eval_every=1)
    np.testing.assert_allclose(out["w"].numpy()[0], np.asarray(js.params["w"]), rtol=1e-5,
                               atol=1e-5)
    logs = [[json.loads(x) for x in (p / "train_log.jsonl").read_text().splitlines()]
            for p in (tmp_path, d / "log")]
    assert [sorted(r) for r in logs[0]] == [sorted(r) for r in logs[1]]
    (j_step, j_eval), (t_step, t_eval) = logs
    assert t_step["step"] == j_step["step"] == 1
    np.testing.assert_allclose(t_step["loss"], j_step["loss"], rtol=1e-5)
    np.testing.assert_allclose(t_eval["eval"]["mse"], j_eval["eval"]["mse"], rtol=1e-5)


def test_data_parallel_parameters_equal_on_every_rank(world):
    d, out = world
    assert out["w_every_rank"].shape == (DATA, 3)
    assert all(torch.equal(row, out["w"][0]) for row in out["w_every_rank"])
    assert (d / "log" / "checkpoints" / "latest.pt").exists()
    assert torch.equal(out["restored"], out["w_every_rank"]) and out["restored_step"] == 1


def test_trainer_saves_a_checkpoint_on_interrupt(tmp_path):
    calls = []

    def loss_fn(m, b):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return (m.weight ** 2).sum()

    tr = Trainer(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.1), log_dir=str(tmp_path),
                 device="cpu")
    with pytest.raises(KeyboardInterrupt):
        tr.fit(tr.init(torch.nn.Linear(2, 1)), [None], num_steps=10)
    assert (tmp_path / "checkpoints" / "interrupt.pt").exists()
    last = json.loads((tmp_path / "train_log.jsonl").read_text().splitlines()[-1])
    assert last == {"step": 2, "interrupted": True}


def test_cosine_lr_equals_optax():
    from depth_estimation_tpu.train import trainer as JT

    for base, T in ((1.0, 100), (3e-2, 7), (0.5, 1), (0.1, 0)):
        ours, theirs = cosine_lr(base, T), JT.cosine_lr(base, T)
        for step in range(0, max(T, 1) + 3):
            np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, atol=1e-9)


def test_train_crf_cli_on_cpu(tmp_path, capsys):
    from PIL import Image

    from depth_estimation_torch.utils.io import write_pfm

    left, right, gt = _pair(24, 32)
    for name, im in (("l.png", left), ("r.png", right)):
        Image.fromarray((im * 255).astype(np.uint8)).save(tmp_path / name)
    write_pfm(tmp_path / "gt.pfm", gt)
    args = ["--left", str(tmp_path / "l.png"), "--right", str(tmp_path / "r.png"),
            "--gt", str(tmp_path / "gt.pfm"), "--steps", "2", "--labels", "4", "--iters", "1",
            "--out", str(tmp_path / "p.npz"), "--device", "cpu"]
    assert train_crf.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["mse_after"]) and out["learned_s_ij"] > 0
    saved = np.load(tmp_path / "p.npz")
    assert {"proj_w", "mu.gamma", "log_s_ij"} <= set(saved.files)
