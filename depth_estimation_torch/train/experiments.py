"""Training experiments of the dense CRF (counterpart of the JAX package's
`train/experiments.py`, its CRF experiments):

- `TrainableDenseCRF` / `train_tsukuba_crf`: learn the guide scales, a
  projection of guidance features into the guide and the Charbonnier
  compatibility by Adam on the masked MSE of the decoded disparity,
  differentiating end to end through the permutohedral lattice;
- `train_uncertainty`: the refiner with an uncertainty head, masked L1;
- `train_upsampler`: the CRF depth upsampler, masked L1.

`torch.optim.Adam` takes the place of `optax.adam`; both step by
m̂/(√v̂ + 1e-8). Each function returns (model, history); the history holds
the loss of every step (before its update), the metric before and after
training, and the host seconds of every step (each ends when its loss
reaches the host). Random draws come from generators seeded by `seed`.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch
import torch.nn as nn

from ..crf.compat import charb_apply, charb_init
from ..crf.guides import pixel_coords
from ..crf.meanfield import crf_as_rnn
from ..models.features import FeatureCNN, VGG16Features, random_features
from ..models.refiner import CRFDepthUpsampler, CRFWithUncertainty, _params
from ..ops.costvolume import cost_volume, expected_disparity
from ..ops.permutohedral import build_plan, lattice_filter_planned
from ..utils.device import resolve_device
from ..utils.weights import load_jax_params
from .metrics import masked_l1, masked_mse

__all__ = ["TrainableDenseCRF", "train_tsukuba_crf", "train_uncertainty", "train_upsampler"]


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


class TrainableDenseCRF(nn.Module):
    """The trainable dense CRF; the JAX package's `trainable_crf_init`
    (parameters `proj_w`, `proj_b`, `log_s_ij`, `log_s_rgb`, `log_s_feat`,
    `mu.gamma`, `mu.log_s`) and `trainable_crf_forward` (`forward`). With
    `cnn`, a `FeatureCNN` computes the guidance features from the image
    and trains with the CRF (its parameters under `cnn.`)."""

    def __init__(self, d_feat: int = 16, d_proj: int = 3, gamma: float = 0.05,
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 cnn: FeatureCNN | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        w = torch.randn(d_feat, d_proj, generator=generator, dtype=dtype) * (1.0 / np.sqrt(d_feat))
        self.proj_w = nn.Parameter(w.to(dev))
        self.proj_b = nn.Parameter(torch.zeros(d_proj, dtype=dtype, device=dev))
        for name, s in (("log_s_ij", 0.1), ("log_s_rgb", 0.1), ("log_s_feat", 10.0)):
            setattr(self, name, nn.Parameter(torch.log(torch.tensor(s, dtype=dtype, device=dev))))
        self.mu = _params(charb_init(gamma, dtype, dev))
        self.cnn = cnn

    def forward(self, logits: torch.Tensor, img: torch.Tensor, feats: torch.Tensor | None = None,
                niters: int = 5) -> torch.Tensor:
        """Refined (h, w, L) logits; the guide is [ij/s_ij, rgb/s_rgb,
        (feats·proj_w + proj_b)/s_feat] with s = exp(log_s), its plan built
        from the detached guide at capacity pow2 ≥ 2n (capped at n·(d+1))."""
        h, w, L = logits.shape
        if feats is None:
            feats = self.cnn(img)
        projected = feats @ self.proj_w + self.proj_b
        guide = torch.cat([pixel_coords(h, w, img.dtype, img.device) / torch.exp(self.log_s_ij),
                           img / torch.exp(self.log_s_rgb),
                           projected / torch.exp(self.log_s_feat)], dim=-1)
        ref = guide.reshape(h * w, -1)
        cap = min(1 << (2 * h * w - 1).bit_length(), h * w * (ref.shape[1] + 1))
        plan = build_plan(ref.detach(), max_vertices=cap)

        def message_fn(Q):
            flat = Q.reshape(h * w, L)
            return (lattice_filter_planned(flat, ref, plan) - flat).reshape(h, w, L)

        return crf_as_rnn(logits, message_fn, lambda Q: charb_apply(self.mu, Q), niters)


def _fit(opt: torch.optim.Optimizer, loss_fn, batches, num_steps: int):
    """`num_steps` Adam steps cycling over `batches`; per-step losses and
    host seconds."""
    losses, seconds = [], []
    for i in range(num_steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(*batches[i % len(batches)])
        loss.backward()
        opt.step()
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    return losses, seconds


def train_tsukuba_crf(left, right, gt, num_steps: int = 300, lr: float = 3e-2,
                      num_disp: int = 16, niters: int = 5, d_feat: int = 16, seed: int = 0,
                      guidance: str = "random", guidance_params: dict | None = None,
                      device=None):
    """Adam training of the CRF on one stereo pair, masked MSE on gt > 0.

    `guidance` picks the features fed to the trainable guide:
      - 'random': seeded random-projection features (training-free);
      - 'cnn': a `FeatureCNN` trained jointly with the CRF;
      - 'vgg': `VGG16Features`, frozen, with `guidance_params` (a JAX
        params tree, loaded by `utils.weights.load_jax_params`); without
        them a random-init VGG16 runs and a UserWarning says that this is
        not the reference's pretrained protocol.

    Returns (model, history) with history['loss'] per step,
    'mse_before'/'mse_after' and 'step_seconds'.
    """
    dev = resolve_device(device)
    left_t, gt_t = _tensor(left, dev), _tensor(gt, dev)
    mask = (gt_t > 0).float()
    logits = -cost_volume(left_t, _tensor(right, dev), num_disp, 9)

    feats, cnn = None, None
    if guidance == "random":
        feats = random_features(left_t, out_dim=d_feat,
                                generator=torch.Generator().manual_seed(seed))
    elif guidance == "cnn":
        cnn = FeatureCNN(out_dim=d_feat, generator=torch.Generator().manual_seed(seed + 1),
                         device=dev)
    elif guidance == "vgg":
        vgg = VGG16Features(generator=torch.Generator().manual_seed(seed + 1), device=dev)
        if guidance_params is None:
            warnings.warn(
                "guidance='vgg' without guidance_params runs a RANDOM-init VGG16; pass "
                "pretrained parameters (utils.weights.load_jax_params) for the reference "
                "protocol (pretrained weights are not bundled).", UserWarning, stacklevel=2)
        else:
            load_jax_params(vgg, guidance_params, device=dev)
        with torch.no_grad():
            full = vgg(left_t)
            # a fixed seeded projection of the 960-d taps to d_feat; the
            # trainable proj_w re-mixes it
            proj = torch.randn(full.shape[-1], d_feat,
                               generator=torch.Generator().manual_seed(seed + 2)).to(dev)
            feats = full @ (proj / np.sqrt(full.shape[-1]))
            feats = (feats - feats.mean((0, 1))) / (feats.std((0, 1), unbiased=False) + 1e-6)
    else:
        raise ValueError(f"unknown guidance {guidance!r}")

    model = TrainableDenseCRF(d_feat=d_feat, generator=torch.Generator().manual_seed(seed),
                              cnn=cnn, device=dev)

    def loss_fn():
        return masked_mse(expected_disparity(model(logits, left_t, feats, niters)), gt_t, mask)

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    with torch.no_grad():
        mse_before = float(loss_fn())
    losses, seconds = _fit(opt, loss_fn, [()], num_steps)
    with torch.no_grad():
        mse_after = float(loss_fn())
    return model, {"loss": losses, "mse_before": mse_before, "mse_after": mse_after,
                   "step_seconds": seconds}


def train_uncertainty(items: list, num_steps: int = 60, lr: float = 1e-3, niters: int = 2,
                      r: int = 15, num_disp: int = 16, d_feat: int = 64, seed: int = 0,
                      unc_weighted: bool = False, device=None):
    """Train the refiner with its uncertainty head end to end by Adam on
    masked L1 (or, with `unc_weighted`, |conf·(d − y)| − log conf). Items
    are dicts with 'left', 'right' (h, w, 3) and 'disparity' (h, w; 0 =
    invalid). Returns (model, history with 'loss', 'l1_before',
    'l1_after', 'step_seconds')."""
    dev = resolve_device(device)
    model = CRFWithUncertainty(d_in=d_feat, generator=torch.Generator().manual_seed(seed),
                               device=dev)

    def prep(item):
        left = _tensor(item["left"], dev)
        logits = -cost_volume(left, _tensor(item["right"], dev), num_disp, 9)
        feats = random_features(left, out_dim=d_feat)
        return logits, left, feats, _tensor(item["disparity"], dev)

    batches = [prep(it) for it in items]

    def loss_fn(logits, img, feats, gt):
        depth, conf = model(logits, img, feats, niters, r)
        if unc_weighted:
            mask = (gt > 0).to(depth.dtype)
            resid = (conf * (depth - gt)).abs() - torch.log(conf + 1e-8)
            return (resid * mask).sum() / mask.sum().clamp_min(1.0)
        return masked_l1(depth, gt)

    def eval_l1():
        with torch.no_grad():
            return float(np.mean([float(masked_l1(model(*b[:3], niters, r)[0], b[3]))
                                  for b in batches]))

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    before = eval_l1()
    losses, seconds = _fit(opt, loss_fn, batches, num_steps)
    return model, {"loss": losses, "l1_before": before, "l1_after": eval_l1(),
                   "step_seconds": seconds}


def train_upsampler(items: list, num_steps: int = 100, lr: float = 3e-3, niters: int = 1,
                    r: int = 5, device=None):
    """Train the CRF depth upsampler by Adam(lr, betas (0.9, 0.9)) on
    masked L1. Items are dicts with 'disp_lowres' (hl, wl), 'image' (h, w,
    3) and 'disparity' (h, w). Returns (model, history with 'loss',
    'l1_before', 'l1_after', 'step_seconds'). The upsampler draws nothing
    at random, so it takes no seed."""
    dev = resolve_device(device)
    model = CRFDepthUpsampler(device=dev)
    batches = [(_tensor(it["disp_lowres"], dev), _tensor(it["image"], dev),
                _tensor(it["disparity"], dev)) for it in items]

    def loss_fn(low, img, gt):
        return masked_l1(model(low, img, niters=niters, r=r), gt)

    def mean_l1():
        with torch.no_grad():
            return float(np.mean([float(loss_fn(*b)) for b in batches]))

    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.9))
    before = mean_l1()
    losses, seconds = _fit(opt, loss_fn, batches, num_steps)
    return model, {"loss": losses, "l1_before": before, "l1_after": mean_l1(),
                   "step_seconds": seconds}
