"""The plain reference agrees with the program at small sizes on the CPU, in
float64 where both can, and imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest
import torch

from benchmark.frames import make_pool
from benchmark.harness import BENCH, ROOT
from benchmark.reference import crf_train, stereo
from benchmark.reference.lattice import Lattice
from depth_estimation_torch.models.pipeline import CRFStereoConfig, crf_stereo_infer, stereo_unary
from depth_estimation_torch.models.refiner import CRFasRNN
from depth_estimation_torch.ops.costvolume import expected_disparity
from depth_estimation_torch.ops.permutohedral import apply_plan, build_plan
from depth_estimation_torch.train.metrics import masked_mse

CFG = dict(num_disp=8, window_size=9, gamma=3.0, mu_scale=1.0, sigma_color=0.1,
           sigma_pos=0.1, niters=3)


@pytest.fixture(scope="module")
def pool():
    # not 3:4: on a frame whose diagonal is a whole number of pixels, pixels of
    # row 0 land exactly on simplex boundaries, where float32 and float64
    # embeddings may pick another vertex of zero weight and so another blur
    return make_pool(2**32 + 17, 3, 50, 64, 3, 6, 0.5, "cpu")


def test_lattice_matches_the_program(pool):
    pos = stereo.positions(pool.left[0], 0.1, 0.1)
    lat = Lattice(pos)
    plan = build_plan(pos, order_by_sum=False)
    assert lat.V == int(plan.num_valid)
    src = torch.randn(pos.shape[0], 3, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    for reverse in (False, True):
        mine, theirs = lat.apply(src, reverse=reverse), apply_plan(plan, src, reverse=reverse)
        assert float((mine - theirs).abs().max()) < 1e-12 * float(theirs.abs().max())


def test_cost_volume_matches_the_program(pool):
    mine = stereo.cost_volume(pool.left[1], pool.right[1], 8, 9)
    theirs = stereo_unary(pool.left[1].double(), pool.right[1].double(),
                          CRFStereoConfig(num_disp=8))
    assert float((mine - theirs).abs().max()) < 1e-9


def test_disparity_matches_the_float32_program(pool):
    ref = stereo.disparity(pool.left[2], pool.right[2], CFG)
    out = crf_stereo_infer(pool.left[2], pool.right[2], CRFStereoConfig(**CFG), device="cpu")
    assert float((out["disparity"].double() - ref).abs().mean()) < 1e-5


def test_training_steps_match_the_float32_program(pool):
    init = {"mu.gamma": 0.05, "mu.log_s": 0.0, "w.s_ij": 0.1, "w.s_rgb": 0.1}
    train = {"lr": 3e-5, "betas": (0.9, 0.999), "eps": 1e-8}
    pairs = [(pool.left[k], pool.right[k], pool.gt[k]) for k in range(3)]
    ref = crf_train.train_steps(pairs, CFG, init, train)
    model = CRFasRNN(backend="lattice", device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=3e-5)
    for t, (left, right, gt) in enumerate(pairs):
        logits = -stereo_unary(left, right, CRFStereoConfig(num_disp=8))
        opt.zero_grad()
        loss = masked_mse(expected_disparity(model(left, logits, niters=3)), gt, (gt > 0).float())
        loss.backward()
        opt.step()
        assert abs(loss.item() / ref["losses"][t] - 1) < 1e-5
        if t == 0:
            for k, p in model.named_parameters():
                assert float(p.grad) == pytest.approx(float(ref["grads"][k]), rel=1e-3)
    for k, p in model.named_parameters():
        assert float(p.detach()) == pytest.approx(float(ref["params"][-1][k]), rel=1e-5, abs=1e-8)


def test_lower_precision_rounding_is_finite():
    x = torch.tensor([1e-4, 1.0, 300.0, 5e4, -2e5], dtype=torch.float64)
    for dt in (torch.float8_e4m3fn, torch.bfloat16):
        y = stereo._rounder(dt)(x)
        assert torch.isfinite(y).all() and float((y - x).abs().max() / x.abs().max()) < 0.07
    assert float(crf_train.to_tf32(torch.tensor(1.0 + 2 ** -12))) == 1.0


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert all(n.split(".")[0] not in ("depth_estimation_torch", "depth_estimation_tpu",
                                               "jax") for n in names), (path, names)
    code = ("import sys, benchmark.reference.stereo, benchmark.reference.crf_train, "
            "benchmark.reference.lattice; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & {"depth_estimation_torch", "depth_estimation_tpu", "jax", "jaxlib",
                         "flax"}
    assert "torch" in loaded
