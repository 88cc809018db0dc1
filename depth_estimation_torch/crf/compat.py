"""Label-compatibility functions μ(l, l') for the dense CRF (counterpart of
the JAX package's `crf/compat.py`). The L×L matrix Mu acts on the label
axis as one small matmul."""
from __future__ import annotations

import torch

__all__ = ["charbonnier", "charbonnier2", "compatibility_matrix", "potts_matrix",
           "charb_matrix"]


def charbonnier(a, b, gamma=0.1):
    """sqrt(γ² + (a−b)²) − γ."""
    return torch.sqrt(gamma ** 2 + (a - b) ** 2) - gamma


def charbonnier2(a, b, gamma=3.0):
    """sqrt(1 + ((a−b)/γ)²) − 1."""
    return torch.sqrt(1.0 + ((a - b) / gamma) ** 2) - 1.0


def compatibility_matrix(compat, labels: torch.Tensor) -> torch.Tensor:
    """Mu[l, l'] = compat(label_l, label_l')."""
    return compat(labels[:, None], labels[None, :])


def potts_matrix(num_labels: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Potts compatibility: 1 − I."""
    return (torch.ones(num_labels, num_labels, dtype=dtype, device=device)
            - torch.eye(num_labels, dtype=dtype, device=device))


def charb_matrix(params: dict, labels: torch.Tensor) -> torch.Tensor:
    """L×L Charbonnier compatibility scaled by exp(log_s); `params` as the
    JAX package's `charb_init` makes them ({'gamma', 'log_s'})."""
    mu = charbonnier(labels[:, None], labels[None, :], params["gamma"])
    return mu * torch.exp(params["log_s"])
