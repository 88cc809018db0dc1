"""Guide (reference-feature) builders for the bilateral CRF (counterpart of
the JAX package's `crf/guides.py`). Images are channels-last (h, w, c);
guides come back as (h, w, d).

Division by a constant is a product with its reciprocal, taken in the
image's dtype, and successive constant scalings fold into one factor;
division by a parameter (a tensor, trainable) stays a division: that is
how XLA compiles the JAX package's guides inside `jit`, so both packages
get the same guide bits and hence the same lattice keys."""
from __future__ import annotations

import torch

from ..utils.device import resolve_device

__all__ = ["pixel_coords", "ij_guide_init", "ij_guide", "ijrgb_guide_init", "ijrgb_guide",
           "stack_guide"]


def _recip(x, dtype, device) -> torch.Tensor:
    return torch.reciprocal(torch.as_tensor(x, dtype=dtype, device=device))


def pixel_coords(h: int, w: int, dtype=torch.float32, device=None,
                 scale=None) -> torch.Tensor:
    """(h, w, 2) (i, j) positions divided by the image diagonal (and
    multiplied by `scale`, folded into the same factor)."""
    ii = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    factor = _recip((h ** 2 + w ** 2) ** 0.5, dtype, device)
    if scale is not None:
        factor = factor * scale
    return torch.stack([ii, jj], dim=-1) * factor


def _param(x, dtype, device) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=resolve_device(device), requires_grad=True)


def ij_guide_init(s_ij: float = 0.1, dtype=torch.float32, device=None) -> dict:
    """Trainable position scale on `device` (None: the GPU)."""
    return {"s_ij": _param(s_ij, dtype, device)}


def ij_guide(params: dict, img: torch.Tensor) -> torch.Tensor:
    """Position-only guide (h, w, 2) = ij/s_ij."""
    h, w = img.shape[:2]
    return pixel_coords(h, w, img.dtype, img.device) / params["s_ij"]


def ijrgb_guide_init(s_ij: float = 0.1, s_rgb: float = 0.1, dtype=torch.float32,
                     device=None) -> dict:
    """Trainable position and colour scales on `device` (None: the GPU)."""
    return {"s_ij": _param(s_ij, dtype, device), "s_rgb": _param(s_rgb, dtype, device)}


def ijrgb_guide(params: dict, img: torch.Tensor) -> torch.Tensor:
    """Bilateral guide (h, w, 2+c) = [ij/s_ij, rgb/s_rgb]; `params` as
    `ijrgb_guide_init` makes them."""
    h, w = img.shape[:2]
    ij = pixel_coords(h, w, img.dtype, img.device) / params["s_ij"]
    return torch.cat([ij, img / params["s_rgb"]], dim=-1)


def stack_guide(img: torch.Tensor, sigma_color: float, sigma_pos: float,
                feats: torch.Tensor | None = None,
                sigma_feat: float | None = None) -> torch.Tensor:
    """Reference stack [rgb/σc, ij/σp (, feats/σf)]."""
    h, w = img.shape[:2]
    parts = [img * _recip(sigma_color, img.dtype, img.device),
             pixel_coords(h, w, img.dtype, img.device,
                          _recip(sigma_pos, img.dtype, img.device))]
    if feats is not None:
        parts.append(feats * _recip(sigma_feat, feats.dtype, feats.device))
    return torch.cat(parts, dim=-1)
