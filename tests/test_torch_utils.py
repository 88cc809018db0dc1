"""The PyTorch port's config, timing, profiling and memory utilities on the
CPU, against the JAX package's where both compute the same thing."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from depth_estimation_torch import config as TC
from depth_estimation_torch.utils import memory, profiling, timing
from depth_estimation_tpu import config as JC


def test_config_roundtrip_and_equal_to_jax():
    cfg = TC.ExperimentConfig()
    assert TC.to_dict(cfg) == JC.to_dict(JC.ExperimentConfig())
    assert TC.from_dict(json.loads(json.dumps(TC.to_dict(cfg)))) == cfg
    partial = {"crf": {"niters": 8, "backend": "guided"}, "mesh": {"tile": 4}, "train": {"lr": 1e-3}}
    assert TC.to_dict(TC.from_dict(partial)) == JC.to_dict(JC.from_dict(partial))
    moved = TC.override(cfg, "mesh.halo", 48)
    assert moved.mesh.halo == 48 and cfg.mesh.halo == 8
    assert TC.to_dict(moved) == JC.to_dict(JC.override(JC.ExperimentConfig(), "mesh.halo", 48))
    assert hash(TC.CRFConfig(niters=3)) != hash(TC.CRFConfig(niters=4))
    assert [f.name for f in dataclasses.fields(TC.ExperimentConfig)] == [
        f.name for f in dataclasses.fields(JC.ExperimentConfig)]


@pytest.mark.parametrize("bad", [{"crf": {"backend": "magic"}}, {"unary": {"window_size": 8}},
                                 {"mesh": {"halo": 0}}, {"crf": {"niters": -1}}])
def test_config_validation_raises(bad):
    with pytest.raises(ValueError, match="invalid config"):
        TC.from_dict(bad)
    with pytest.raises(AssertionError):
        JC.from_dict(bad)


def test_chain_timer_returns_nan_on_a_non_positive_difference(monkeypatch):
    """A clock under which the long chain takes no longer than the short one
    gives NaN, not a tiny time (as the JAX version)."""
    ticks = iter([0.0, 1.0, 0.0, 1.0] * 4)
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    assert np.isnan(timing.chain_timer(lambda acc: acc + 1, reps=3, device="cpu"))
    ticks = iter([0.0, 1.0, 0.0, 1.0] * 4)
    assert np.isnan(timing.loop_timer(lambda acc: acc + 1, reps=3, device="cpu"))


def test_chain_timer_differences_the_chains(monkeypatch):
    """The least of the 1-chains' times, 2 s, and of the 5-chains', 10 s,
    run in turns, give (10 − 2) / 4 = 2 s a step; the steps really run,
    1 + 3·1 + 3·5 times."""
    ticks = iter([0.0, 3.0, 0.0, 12.0, 0.0, 2.0, 0.0, 10.0, 0.0, 2.5, 0.0, 11.0])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    calls = []

    def step(acc):
        calls.append(1)
        return acc + torch.ones(3).sum()

    assert timing.RUNS == 3
    assert timing.chain_timer(step, reps=5, device="cpu") == 2.0
    assert len(calls) == 19


@pytest.mark.parametrize("timer", ["chain_timer", "loop_timer"])
def test_one_slow_short_chain_leaves_the_time_finite(monkeypatch, timer):
    """A 1-chain slowed past the 3-chains' time (a host preempted mid-run)
    is outvoted by the other 1-chains: (3 − 1) / 2 = 1 s a step, not NaN.
    (loop_timer's untimed warm-up reads the clock too.)"""
    warm = [0.0, 1.0] if timer == "loop_timer" else []
    ticks = iter(warm + [0.0, 5.0, 0.0, 3.0] + [0.0, 1.0, 0.0, 3.0] * 2)
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    assert getattr(timing, timer)(lambda acc: acc + 1, reps=3, device="cpu") == 1.0


def test_scalarize_and_jitter_match_jax():
    import jax.numpy as jnp

    from depth_estimation_tpu.utils import timing as JT

    rs = np.random.RandomState(0)
    a, b = rs.rand(4, 3).astype(np.float32), rs.rand(5) > 0.5
    got = timing.scalarize({"a": torch.from_numpy(a), "x": [torch.from_numpy(b), 3]})
    want = JT.scalarize({"a": jnp.asarray(a), "x": [jnp.asarray(b)]})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    x = torch.from_numpy(a)
    assert torch.equal(timing.jitter(x, torch.tensor(1.0)), x)
    assert timing.scalarize([]).item() == 0.0


def test_roofline_and_trace_run_on_the_cpu(tmp_path):
    from depth_estimation_tpu.utils import profiling as JP

    r = profiling.roofline(1e-3, 3.35e9, 67e9)
    assert r == pytest.approx(JP.roofline(1e-3, 3.35e9, 67e9, peaks=profiling.H100_PEAK))
    assert r["hbm_fraction"] == pytest.approx(1.0) and r["flops_fraction_f32"] == pytest.approx(1.0)
    path = tmp_path / "trace.json"
    with profiling.trace(path):
        with profiling.span("lattice.splat"):
            torch.ones(16).cumsum(0)
    events = json.loads(path.read_text())["traceEvents"]
    # the program's spans are in the exported trace, above the ops they hold
    assert any(e.get("name") == "lattice.splat" for e in events)


def test_memory_report_runs_on_the_cpu():
    keep = [torch.zeros(1000, dtype=torch.float32), torch.zeros(500, dtype=torch.int64)]
    lines = []
    report = memory.live_array_report(print_fn=lines.append, top=3)
    cpu = report["cpu"]
    assert cpu["count"] >= 2 and cpu["bytes"] >= 8000
    assert cpu["dtypes"]["float32"] >= 4000 and cpu["dtypes"]["int64"] >= 4000
    assert lines[0].endswith("live tensors") and any(x.startswith("TOTAL cpu") for x in lines)
    assert memory.format_bytes(3 * 1024 ** 2) == "3.00 MiB"
    if not torch.cuda.is_available():
        assert memory.device_memory_stats() == {}
    del keep
