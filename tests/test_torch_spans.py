"""The port's spans and counters (`utils.profiling`): off unless a torch
profiler records, host events on the profiler's timeline when on, to which
the profiler attributes the device's work, and the layers of the stereo
pipeline and the CRF layer that record them.

This file imports neither JAX nor the JAX package, so the card's test
runs on a GPU machine without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from depth_estimation_torch.models.pipeline import CRFStereoConfig, crf_stereo_infer
from depth_estimation_torch.models.refiner import CRFasRNN
from depth_estimation_torch.utils import profiling as P

SPANS = ("stereo.frame", "stereo.unary", "lattice.plan", "lattice.splat", "lattice.blur",
         "lattice.slice", "lattice.backward", "crf.forward")


@pytest.fixture(autouse=True)
def empty_counters():
    P.reset_counters()
    yield
    P.reset_counters()


def _pair(device="cpu"):
    g = torch.Generator().manual_seed(0)
    left = torch.rand(32, 48, 3, generator=g)
    return left.to(device), torch.roll(left, -2, 1).to(device)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _refuse(*args, **kwargs):
    raise AssertionError("a range was opened with no profiler recording")


def _span_parents(prof, name):
    """The names of the spans that the spans `name` of `prof` opened under
    (None: none), each the nearest span up the profiler's own nesting."""
    parents = set()
    for e in prof.events():
        if e.name == name:
            up = e.cpu_parent
            while up is not None and up.name not in P._NAMES:
                up = up.cpu_parent
            parents.add(None if up is None else up.name)
    return parents


def test_span_off_is_the_shared_null_context(monkeypatch):
    monkeypatch.setattr(P, "_RecordFunctionFast", _refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = P.span("lattice.splat")
    assert P.span("lattice.splat") is first
    with first:
        torch.ones(4).sum()

    @P.span("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2


def test_count_off_stores_nothing():
    P.count("lattice.vertices", torch.tensor(7))
    P.count("lattice.capacity", 16)
    assert P.counter_totals() == {}


def test_spans_on_are_host_events_and_no_user_annotation():
    with _cpu_profile() as prof:
        with P.span("outer"):
            with P.span("inner"):
                torch.ones(8).cumsum(0)
    events = {e.name: e for e in prof.events() if e.name in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    for e in events.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
    assert events["inner"].cpu_parent.name == "outer"
    assert _span_parents(prof, "outer") == {None}


def test_spans_nest_under_their_own_thread_parent():
    def other():
        with P.span("thread.outer"):
            with P.span("thread.inner"):
                torch.ones(4).sum()

    # the profiler follows every thread here, as it follows autograd's
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        with P.span("main.outer"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
            with P.span("main.inner"):
                pass
    assert _span_parents(prof, "thread.outer") == {None}
    assert _span_parents(prof, "thread.inner") == {"thread.outer"}
    assert _span_parents(prof, "main.inner") == {"main.outer"}


def test_span_totals_on_the_cpu_and_after_a_raise():
    @P.span("deco")
    def f():
        torch.ones(64, 64) @ torch.ones(64, 64)

    with _cpu_profile() as prof:
        for _ in range(3):
            f()
        with pytest.raises(ValueError):
            with P.span("raises"):
                raise ValueError("inside")
        with P.span("after"):
            f()
        P.count("n", 2)
        P.count("n", torch.tensor(5))
    spans = P.span_totals(prof)
    assert {k: v["count"] for k, v in spans.items()} == {"deco": 4, "raises": 1, "after": 1}
    # a span closed by an exception leaves no parent behind
    assert _span_parents(prof, "after") == {None}
    assert _span_parents(prof, "deco") == {None, "after"}
    for s in spans.values():
        assert s["host_s"] > 0 and s["device_s"] == 0  # no device traced
    assert P.counter_totals() == {"n": 7}


def test_a_span_made_while_a_profiler_records_also_decorates():
    with _cpu_profile() as prof:
        @P.span("late")
        def g(x):
            return x * 2

        assert g(3) == 6
    assert g(4) == 8  # off again
    assert P.span_totals(prof)["late"]["count"] == 1


def test_reset_spans_empties_the_store():
    with _cpu_profile():
        with P.span("a"):
            P.count("c", torch.tensor(3))
    assert P.counter_totals() == {"c": 3}
    P.reset_counters()
    assert P.counter_totals() == {}


@pytest.mark.parametrize("num_lattices,tiled", [(1, False), (2, False), (1, True)])
def test_pipeline_records_each_layer(num_lattices, tiled):
    left, right = _pair()
    niters = 2
    cfg = CRFStereoConfig(num_disp=4, niters=niters, num_lattices=num_lattices)
    if tiled:
        cfg = CRFStereoConfig(num_disp=4, niters=niters, tile_px=16, tile_u=256,
                              sort_mode="packed1")
    with _cpu_profile() as prof:
        out = crf_stereo_infer(left, right, cfg, device="cpu")
    counts = {k: v["count"] for k, v in P.span_totals(prof).items()}
    k = num_lattices
    assert counts == {"stereo.frame": 1, "stereo.unary": 1, "lattice.plan": k,
                      "lattice.splat": niters * k, "lattice.blur": niters * k,
                      "lattice.slice": niters * k}
    plans = out["plans"]
    assert len(plans) == k and (plans[0].slot is None) == tiled
    # each untiled apply and the cost volume's call are counted; on the CPU
    # none runs the kernels
    untiled = {} if tiled else {"lattice.apply.untiled": niters * k}
    assert P.counter_totals() == {
        "lattice.vertices": sum(int(p.num_valid) for p in plans),
        "lattice.capacity": sum(p.capacity for p in plans), "costvolume.calls": 1, **untiled}
    for name in counts:
        want = (None,) if name == "stereo.frame" else ("stereo.frame",)
        assert _span_parents(prof, name) == set(want)


def _crf_step(model, left, logits, niters):
    model.zero_grad(set_to_none=True)
    out = model(left, logits, niters=niters)
    out.square().mean().backward()
    return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_crf_as_rnn_records_a_backward_span_per_iteration():
    left, _ = _pair()
    logits = torch.randn(32, 48, 4, generator=torch.Generator().manual_seed(1))
    model = CRFasRNN(backend="lattice", device="cpu")
    niters = 3
    with _cpu_profile() as prof:
        _crf_step(model, left, logits, niters)
    spans = P.span_totals(prof)
    assert spans["crf.forward"]["count"] == 1 and spans["lattice.plan"]["count"] == 1
    assert spans["lattice.backward"]["count"] == niters
    # each backward filters twice (∂src and ∂ref), each forward iteration once
    assert spans["lattice.splat"]["count"] == 3 * niters
    assert _span_parents(prof, "lattice.splat") == {"crf.forward", "lattice.backward"}
    assert _span_parents(prof, "lattice.backward") == {None}


def test_outputs_and_gradients_are_the_same_with_spans_on_and_off():
    left, right = _pair()
    cfg = CRFStereoConfig(num_disp=4, niters=2)
    off = crf_stereo_infer(left, right, cfg, device="cpu")
    with _cpu_profile():
        on = crf_stereo_infer(left, right, cfg, device="cpu")
    for key in ("disparity", "disparity_unary", "probabilities", "unary"):
        assert torch.equal(off[key], on[key]), key
    logits = torch.randn(32, 48, 4, generator=torch.Generator().manual_seed(1))
    model = CRFasRNN(backend="lattice", device="cpu")
    out_off, grads_off = _crf_step(model, left, logits, 2)
    with _cpu_profile():
        out_on, grads_on = _crf_step(model, left, logits, 2)
    assert torch.equal(out_off, out_on)
    assert grads_off.keys() == grads_on.keys()
    for k in grads_off:
        assert torch.equal(grads_off[k], grads_on[k]), k


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_spans_add_no_device_event_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a span's device time is the kernels the profiler "
                    "correlates with it")
    left, right = _pair("cuda")
    cfg = CRFStereoConfig(num_disp=8, niters=2)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    crf_stereo_infer(left, right, cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        crf_stereo_infer(left, right, cfg, device="cuda")
        torch.cuda.synchronize()
    spans = P.span_totals(prof)
    assert set(spans) == set(SPANS[:6])
    assert all(s["device_s"] > 0 for s in spans.values()), spans
    # the frame's device time holds its layers'
    inner = sum(s["device_s"] for k, s in spans.items() if k != "stereo.frame")
    assert spans["stereo.frame"]["device_s"] >= inner
    on = _device_events(prof)
    assert not [e.name for e in on if e.name in SPANS or e.is_user_annotation]
    # the same call with the spans held off while the profiler records
    monkeypatch.setattr(P, "_autograd_profiler", type("off", (), {"_is_profiler_enabled": False}))
    with profile(activities=acts) as prof:
        crf_stereo_infer(left, right, cfg, device="cuda")
        torch.cuda.synchronize()
    assert P.span_totals(prof) == {}
    off = _device_events(prof)
    assert sorted(e.name for e in on) == sorted(e.name for e in off)


