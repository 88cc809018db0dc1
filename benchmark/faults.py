"""Faults planted under the timed path, to show that the comparison which
decides `correct` catches them. Each is a context manager that patches
the program (or the entry's call into it) for as long as it is open.

- `unchanged_state`: a training step that returns its state unchanged
  (Adam's step does nothing);
- `half_batch`: half of the batch left out: the training loss's mean over
  the upper half of the pair's pixels only, or the server computing the
  first half of each batch and answering it for the second half too;
- `answer_altered`: every disparity map off by two pixels where it is
  produced (the decode's labels counted from 2).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS", "planted"]


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged_state():
    return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)


@contextlib.contextmanager
def half_batch():
    from depth_estimation_torch.models.serving import StereoServer

    from .entries import train

    loss = train.masked_mse

    def upper_half(pred, gt, mask):
        keep = torch.zeros_like(mask)
        keep[: mask.shape[0] // 2] = 1
        return loss(pred, gt, mask * keep)

    serve = StereoServer._serve

    def first_half(self, left, right):
        half = serve(self, left[: left.shape[0] // 2], right[: right.shape[0] // 2])
        return torch.cat([half, half])[: left.shape[0]]

    with _patched(train, "masked_mse", upper_half), _patched(StereoServer, "_serve", first_half):
        yield


@contextlib.contextmanager
def answer_altered():
    from depth_estimation_torch.models import serving

    from .entries import stream

    infer = stream.crf_stereo_infer

    def off_by_two(*args, **kwargs):
        out = infer(*args, **kwargs)
        return {**out, "disparity": out["disparity"] + 2.0}

    with _patched(stream, "crf_stereo_infer", off_by_two), \
            _patched(serving, "crf_stereo_infer", off_by_two):
        yield


# the faults each kind of entry can have
FAULTS = {"stream": ("answer_altered",),
          "serve": ("half_batch", "answer_altered"),
          "train": ("unchanged_state", "half_batch")}


def planted(name: str):
    return {"unchanged_state": unchanged_state, "half_batch": half_batch,
            "answer_altered": answer_altered}[name]()
