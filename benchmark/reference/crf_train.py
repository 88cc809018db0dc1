"""Plain CRF-as-RNN training steps: what the benchmark's training cells
must produce, computed from the pairs and the initial parameters alone.

One step on a pair (left, right, gt):

    logits0 = −E0 (the cost volume of `reference.stereo`)
    pos     = [(i, j) / √(h² + w²) / s_ij, rgb / s_rgb]
    Mu(θ)   = (√(γ² + (l − m)²) − γ) · exp(log_s)
    Q = softmax(logits0)
    niters × { C = Q·Mu;  logits = logits0 − (filter(C) − C);  Q = softmax(logits) }
    loss    = Σ (Σ_l Q_l · l − gt)² · [gt > 0] / max(Σ [gt > 0], 1)

the filter through `reference.lattice` with the Gaussian's gradients in the
values and the positions (its vertices chosen by the positions as the
float32 configuration computes them), then one Adam step (bias-corrected,
as Kingma & Ba write it). Parameters: `mu.gamma`, `mu.log_s`, `w.s_ij`, `w.s_rgb`.
`dtype` is the precision of the whole computation and `tf32`, where set,
rounds the operands of every matrix product to TF32's 10-bit mantissa: the
control puts that in the program's place. It imports nothing of the program.
"""
from __future__ import annotations

import torch

from .lattice import filter_with_grad
from .stereo import cost_volume

__all__ = ["NAMES", "to_tf32", "train_steps"]

NAMES = ("mu.gamma", "mu.log_s", "w.s_ij", "w.s_rgb")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits), with
    the gradient passed straight through."""
    bits = x.detach().float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)
    return x + (r - x).detach()


def _embedding_positions(p: dict, left: torch.Tensor) -> torch.Tensor:
    """The positions as the float32 configuration computes them, (i, j)
    times the float32 reciprocal of the diagonal over s_ij, rgb over s_rgb,
    from the parameters rounded to float32: they choose the lattice's
    vertices."""
    h, w = left.shape[:2]
    f32 = torch.float32
    ii, jj = torch.meshgrid(torch.arange(h, dtype=f32, device=left.device),
                            torch.arange(w, dtype=f32, device=left.device), indexing="ij")
    factor = torch.reciprocal(torch.tensor((h ** 2 + w ** 2) ** 0.5, dtype=f32,
                                           device=left.device))
    ij = torch.stack([ii, jj], -1) * factor / p["w.s_ij"].detach().to(f32)
    rgb = left.to(f32) / p["w.s_rgb"].detach().to(f32)
    return torch.cat([ij, rgb], -1).reshape(h * w, -1)


def _loss(p: dict, left, logits, gt, niters: int, rnd) -> torch.Tensor:
    h, w, L = logits.shape
    dt = logits.dtype
    ii, jj = torch.meshgrid(torch.arange(h, dtype=dt, device=left.device),
                            torch.arange(w, dtype=dt, device=left.device), indexing="ij")
    ij = torch.stack([ii, jj], -1) / (h ** 2 + w ** 2) ** 0.5
    pos = torch.cat([ij / p["w.s_ij"], left.to(dt) / p["w.s_rgb"]], -1).reshape(h * w, -1)
    embed = _embedding_positions(p, left)
    labels = torch.arange(L, dtype=dt, device=left.device)
    Mu = ((torch.sqrt(p["mu.gamma"] ** 2 + (labels[:, None] - labels[None, :]) ** 2)
           - p["mu.gamma"]) * torch.exp(p["mu.log_s"]))
    E0 = -logits.reshape(h * w, L)
    out = -E0
    Q = torch.softmax(out, -1)
    for _ in range(niters):
        C = rnd(Q) @ rnd(Mu)
        out = -(E0 + filter_with_grad(C, pos, embed, rnd) - C)
        Q = torch.softmax(out, -1)
    disp = (rnd(Q) @ rnd(labels)).reshape(h, w)
    mask = (gt > 0).to(dt)
    return ((disp - gt.to(dt)) ** 2 * mask).sum() / mask.sum().clamp_min(1.0)


def train_steps(pairs, cfg: dict, init: dict, train: dict, dtype=torch.float64,
                tf32: bool = False, follow=None) -> dict:
    """Adam steps from `init`, one a pair of `pairs` ((left, right, gt)
    tuples), under configuration `cfg` (num_disp, window_size, niters) and
    the training settings `train` (lr, betas, eps). With `follow`, a list
    of parameter dicts, step t takes its loss and gradient at `follow[t]`
    (an implementation's own state before that step) and Adam sums its
    own steps from there. Returns each step's loss, the first step's
    gradients, the parameters after each step and the change over all the
    steps, as float64 tensors on the pairs' device, by name."""
    rnd = to_tf32 if tf32 else (lambda x: x)
    dev = pairs[0][0].device
    own = {k: torch.tensor(float(init[k]), dtype=dtype, device=dev) for k in NAMES}
    m = {k: torch.zeros((), dtype=dtype, device=dev) for k in NAMES}
    v = {k: torch.zeros((), dtype=dtype, device=dev) for k in NAMES}
    change = {k: torch.zeros((), dtype=dtype, device=dev) for k in NAMES}
    b1, b2 = train["betas"]
    losses, grads, params = [], None, []
    for t, (left, right, gt) in enumerate(pairs, start=1):
        at = own if follow is None else {k: torch.as_tensor(follow[t - 1][k]).to(dev, dtype)
                                         for k in NAMES}
        p = {k: at[k].clone().requires_grad_(True) for k in NAMES}
        logits = -cost_volume(left, right, cfg["num_disp"], cfg["window_size"]).to(dtype)
        loss = _loss(p, left, logits, gt, cfg["niters"], rnd)
        g = torch.autograd.grad(loss, [p[k] for k in NAMES])
        losses.append(float(loss.detach()))
        if grads is None:
            grads = {k: gk.detach().double() for k, gk in zip(NAMES, g)}
        with torch.no_grad():
            for k, gk in zip(NAMES, g):
                m[k] = b1 * m[k] + (1 - b1) * gk
                v[k] = b2 * v[k] + (1 - b2) * gk * gk
                step = train["lr"] * (m[k] / (1 - b1 ** t)) / (
                    torch.sqrt(v[k] / (1 - b2 ** t)) + train["eps"])
                own[k] = own[k] - step
                change[k] = change[k] - step
        params.append({k: own[k].double().clone() for k in NAMES})
    return {"losses": losses, "grads": grads, "params": params,
            "change": {k: c.double() for k, c in change.items()}}
