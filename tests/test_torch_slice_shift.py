"""The shifted slice on the CPU: the mean field's message, each row shifted
to a minimum of 0 and rounded to bf16 by the lattice apply's slice itself
(`apply_plan(..., shift_out=True)`, `ops/cuda/lattice.slice_untiled_shifted`).

On the CPU the shifted slice is the plain version: the slice, then the
shift and the cast. These tests hold it to the f32 slice followed by
`S - S.amin(1)` rounded to bf16, bit for bit, and hold the fused bf16
pipeline's disparities to those of the separate shift and cast it
replaces. Only the fused loop with a bf16 state and one plan takes it;
other configurations count no shifted slice."""
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from depth_estimation_torch.crf.guides import stack_guide
from depth_estimation_torch.data.synthetic import make_stereo_pair
from depth_estimation_torch.models import pipeline as TP
from depth_estimation_torch.ops import permutohedral as P
from depth_estimation_torch.ops.cuda import lattice as LK
from depth_estimation_torch.utils import profiling

H, W = 64, 96
# labels: a team of 2 lanes, fullres128's row, wide320's row, and one off
# the 8-value words (one value a lane on the card)
SHIFT_L = [16, 128, 320, 100]


def _pair(seed=0, max_disp=7):
    left, right, _ = make_stereo_pair(np.random.RandomState(seed), H, W, num_layers=4,
                                      max_disp=max_disp)
    return left.astype(np.float32), right.astype(np.float32)


def _plan(case: str):
    """The untiled plan of a 64×96 pair's guide, at a capacity above its
    occupancy ('fits') or below it ('overflow': the overflow entries
    gather the sentinel row C)."""
    left, _ = _pair()
    guide = stack_guide(torch.from_numpy(left), 0.1, 0.1).reshape(H * W, -1)
    cap = 512 if case == "overflow" else 16384
    plan = P.build_plan(guide, max_vertices=cap)
    assert (int(plan.num_valid) > cap) == (case == "overflow")
    return plan


def _shifted(S: torch.Tensor) -> torch.Tensor:
    """The message as the fused loop made it before: the f32 rows less their
    minima, rounded to bf16."""
    return (S - S.amin(1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L", SHIFT_L)
@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_shifted_slice_is_the_slice_less_its_row_minima_in_bf16(case, L, dtype):
    plan = _plan(case)
    g = torch.Generator().manual_seed(L)
    vals = (torch.rand(plan.capacity + 1, L, generator=g) * 50).to(dtype)
    vals[plan.capacity] = (torch.rand(L, generator=g) * 50).to(dtype)  # row C, as gathered
    got = LK.slice_untiled_shifted(plan, vals)
    S = LK.slice_untiled_reference(plan, vals)
    assert S.dtype == torch.float32
    assert got.dtype == torch.bfloat16 and got.shape == (H * W, L) and got.is_contiguous()
    assert torch.equal(got, _shifted(S))
    assert torch.equal(LK.shift_rows_bf16(S), got)
    assert not got.amin(1).any()  # each row's minimum is 0
    if case == "overflow":  # the sentinel row takes part: another row C moves the overflow pixels
        moved = vals.clone()
        moved[plan.capacity] += (torch.arange(L) % 7 * 3).to(dtype)  # not a constant, which goes
        again = LK.slice_untiled_shifted(plan, moved)
        hits = (plan.slot == plan.capacity).any(1)
        assert hits.any() and not torch.equal(again[hits], got[hits])
        assert torch.equal(again[~hits], got[~hits])


@pytest.mark.parametrize("L", [16, 100])
def test_apply_plan_shifts_its_output_as_the_separate_shift_did(L):
    """`apply_plan(shift_out=True)` is the apply with `shift_rows` followed
    by the shift and cast, for an untiled plan (the shifted slice, counted)
    and a tiled one (the tiled slice then `shift_rows_bf16`, not counted)."""
    left, _ = _pair()
    guide = stack_guide(torch.from_numpy(left), 0.1, 0.1).reshape(H * W, -1)
    g = torch.Generator().manual_seed(5)
    src = torch.rand(H * W, L, generator=g).to(torch.bfloat16)
    untiled = P.build_plan(guide, max_vertices=16384)
    tiled = P.build_plan(TP.blocked(guide.reshape(H, W, -1), 32), max_vertices=16384, tile=1024,
                         tile_u=256)
    for plan, counted in ((untiled, 1), (tiled, 0)):
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            got = P.apply_plan(plan, src, shift_rows=True, shift_out=True)
        assert profiling.counter_totals().get("lattice.slice.shifted", 0) == counted
        before = P.apply_plan(plan, src, shift_rows=True)
        want = torch.sub(before, before.amin(1, keepdim=True),
                         out=torch.empty(before.shape, dtype=torch.bfloat16))
        assert torch.equal(got, want)
    profiling.reset_counters()


def test_shifted_slice_refuses_a_gradient():
    plan = _plan("fits")
    vals = torch.rand(plan.capacity + 1, 16, requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        LK.slice_untiled_shifted(plan, vals)


def test_zero_launch_counts_zeroes_the_shifted_slice_count():
    LK.lattice_slice.shifted_launches = 3
    LK.zero_launch_counts()
    assert LK.lattice_slice.shifted_launches == 0
    assert LK.launch_counts() == {"splat": 0, "slice": 0}


def _infer_counted(left, right, cfg):
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = TP.crf_stereo_infer(left, right, cfg, device="cpu")
    shifted = profiling.counter_totals().get("lattice.slice.shifted", 0)
    profiling.reset_counters()
    return out, shifted


def _separate_shift_apply(plan, x, reverse=False, shift_rows=False, shift_out=False):
    """`apply_plan` as the fused loop used it before: the f32 slice, then its
    rows' minima subtracted into a bf16 tensor."""
    S = P.apply_plan(plan, x, reverse=reverse, shift_rows=shift_rows)
    if not shift_out:
        return S
    return torch.sub(S, S.amin(1, keepdim=True), out=torch.empty(S.shape, dtype=torch.bfloat16))


@pytest.mark.parametrize("L,tiled", [(24, False), (100, False), (24, True)])
def test_bf16_pipeline_gives_the_disparities_of_the_separate_shift(monkeypatch, L, tiled):
    """The fused bf16 pipeline on a 64×96 pair: through the shifted slice
    (one untiled plan: a shifted slice an iteration) and through the
    separate shift and cast it replaces, the same disparity bits."""
    left, right = _pair(1, max_disp=min(L - 2, 20))
    cfg = TP.CRFStereoConfig(num_disp=L, niters=3, compute_dtype="bf16", fused_update=True,
                             max_vertices=16384, tile_px=32 if tiled else None, tile_u=256)
    out, shifted = _infer_counted(left, right, cfg)
    assert shifted == (0 if tiled else cfg.niters)
    assert (out["plans"][0].tile_A is not None) == tiled
    with monkeypatch.context() as m:
        m.setattr(TP, "apply_plan", _separate_shift_apply)
        before, shifted_before = _infer_counted(left, right, cfg)
    assert shifted_before == 0
    assert np.isfinite(out["disparity"].numpy()).all()
    for key in ("disparity", "probabilities"):
        assert torch.equal(out[key], before[key]), key


@pytest.mark.parametrize("change", [{"num_lattices": 2}, {"compute_dtype": "f32"},
                                    {"fused_update": False}])
def test_other_configurations_take_no_shifted_slice(change):
    """Two lattices (the mean of two filters is shifted after the sum), an
    f32 state (no shift) and the unfused mean field keep the f32 slice."""
    left, right = _pair(2)
    cfg = replace(TP.CRFStereoConfig(num_disp=16, niters=2, compute_dtype="bf16",
                                     fused_update=True, max_vertices=16384), **change)
    out, shifted = _infer_counted(left, right, cfg)
    assert shifted == 0
    assert np.isfinite(out["disparity"].numpy()).all()
