"""Guide (reference-feature) builders for the bilateral CRF (counterpart of
the JAX package's `crf/guides.py`). Images are channels-last (h, w, c);
guides come back as (h, w, d).

Division by a scalar is a product with its reciprocal, taken in the
image's dtype, and successive scalings fold into one factor: that is how
XLA compiles the JAX package's guides inside `jit`, so both packages get
the same guide bits and hence the same lattice keys."""
from __future__ import annotations

import torch

__all__ = ["pixel_coords", "ijrgb_guide", "stack_guide"]


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


def ijrgb_guide(params: dict, img: torch.Tensor) -> torch.Tensor:
    """Bilateral guide (h, w, 2+c) = [ij/s_ij, rgb/s_rgb]; `params` as the
    JAX package's `ijrgb_guide_init` makes them."""
    h, w = img.shape[:2]
    ij = pixel_coords(h, w, img.dtype, img.device, _recip(params["s_ij"], img.dtype, img.device))
    return torch.cat([ij, img * _recip(params["s_rgb"], img.dtype, img.device)], dim=-1)


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
