"""Mean-field inference for fully connected CRFs (counterpart of
the JAX package's `crf/meanfield.py`).

An eager loop keeps only the live state: one iteration's (n, L) tensors
are freed as the next is made (autograd keeps what a backward needs).
Layout: label axis last.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["mean_field_logits", "mean_field_infer", "crf_as_rnn"]


def _matmul_like(Q: torch.Tensor, Mu: torch.Tensor) -> torch.Tensor:
    """Q·Mu accumulated in f32 and rounded once to Q's dtype."""
    return (Q.float() @ Mu.float()).to(Q.dtype)


def mean_field_logits(
    E0: torch.Tensor,
    message_fn: Callable[[torch.Tensor], torch.Tensor],
    compat_fn: Callable[[torch.Tensor], torch.Tensor],
    niters: int = 5,
) -> torch.Tensor:
    """Q ← softmax(−E0); repeat E = E0 + message_fn(compat_fn(Q)),
    Q = softmax(−E); returns the final logits −E."""
    logits = -E0
    Q = torch.softmax(logits, dim=-1)
    for _ in range(niters):
        logits = -(E0 + message_fn(compat_fn(Q)))
        Q = torch.softmax(logits, dim=-1)
    return logits


def mean_field_infer(
    E0: torch.Tensor,
    message_fn: Callable[[torch.Tensor], torch.Tensor],
    Mu: torch.Tensor | Callable[[torch.Tensor], torch.Tensor],
    niters: int = 10,
) -> torch.Tensor:
    """Label probabilities Q after `niters` iterations; `Mu` is an L×L
    matrix or a callable Q ↦ Q·Mu."""
    compat_fn = Mu if callable(Mu) else (lambda Q: _matmul_like(Q, Mu))
    return torch.softmax(mean_field_logits(E0, message_fn, compat_fn, niters), dim=-1)


def crf_as_rnn(
    logits: torch.Tensor,
    message_fn: Callable[[torch.Tensor], torch.Tensor],
    compat_fn: Callable[[torch.Tensor], torch.Tensor],
    niters: int = 5,
    confidence: torch.Tensor | None = None,
) -> torch.Tensor:
    """The trainable CRF layer: refined (..., L) logits from unary logits
    (E0 = −logits·confidence, `confidence` a broadcastable per-pixel weight
    in [0, 1] or None), differentiable through every iteration."""
    E0 = -logits if confidence is None else -logits * confidence
    return mean_field_logits(E0, message_fn, compat_fn, niters)
