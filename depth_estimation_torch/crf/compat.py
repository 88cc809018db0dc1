"""Label-compatibility functions μ(l, l') for the dense CRF (counterpart of
the JAX package's `crf/compat.py`). The L×L matrix Mu acts on the label
axis as one small matmul. The trainable Charbonnier's parameters are a dict
{'gamma', 'log_s'} of scalar tensors that require grad; the energy scale is
exp(log_s)."""
from __future__ import annotations

import torch

from ..utils.device import resolve_device

__all__ = ["charbonnier", "charbonnier2", "compatibility_matrix", "potts_matrix",
           "charb_init", "charb_matrix", "charb_apply", "charb_energies_from_scalar"]


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


def charb_init(gamma: float = 0.05, dtype=torch.float32, device=None) -> dict:
    """Trainable Charbonnier compatibility parameters on `device` (None:
    the GPU)."""
    dev = resolve_device(device)
    return {"gamma": torch.tensor(gamma, dtype=dtype, device=dev, requires_grad=True),
            "log_s": torch.tensor(0.0, dtype=dtype, device=dev, requires_grad=True)}


def charb_matrix(params: dict, labels: torch.Tensor) -> torch.Tensor:
    """L×L Charbonnier compatibility scaled by exp(log_s); `params` as the
    JAX package's `charb_init` makes them ({'gamma', 'log_s'})."""
    mu = charbonnier(labels[:, None], labels[None, :], params["gamma"])
    return mu * torch.exp(params["log_s"])


def charb_apply(params: dict, Q: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
    """Q·Mu over the trailing label axis (default labels 0..L−1)."""
    if labels is None:
        labels = torch.arange(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return Q @ charb_matrix(params, labels)


def charb_energies_from_scalar(params: dict, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unary energies from a scalar map: charbonnier(label, x, γ·max(label))
    · exp(log_s), labels broadcast against x's trailing singleton axis."""
    gamma = params["gamma"] * labels.max()
    return charbonnier(labels, x, gamma) * torch.exp(params["log_s"])
