"""Row-striped end-to-end stereo CRF (counterpart of the JAX package's
`parallel/stereo_tiled.py`).

Each rank of the mesh's tile axis runs the whole pipeline on its row stripe
padded with `halo` rows from each neighbour (zero rows at the image's outer
edges): cost volume, a bilateral guide with GLOBAL pixel positions,
its own untiled lattice plan, float32 mean-field iterations and the decode;
then it drops the halo. The bilateral position kernel couples about
σp·diag pixels, so the stripes match the untiled pipeline only to the
halo's truncation: a halo of about σp·√(h² + w²) (48 px at 288×384 and
σp = 0.1) recovers the untiled solution; the default 16 favours speed.

Like the JAX version it ignores `tile_px`, `tile_bf16`, `sort_mode`,
`num_lattices`, `compute_dtype` and `fused_update`: the mean field is the
plain float32 loop, so this path launches no CUDA kernel.
"""
from __future__ import annotations

import torch

from ..crf.compat import charbonnier2, compatibility_matrix
from ..crf.meanfield import mean_field_infer
from ..models.pipeline import CRFStereoConfig, _as_image, stereo_unary
from ..ops.costvolume import expected_disparity
from ..ops.permutohedral import apply_plan, build_plan
from ..utils.device import resolve_device
from .mesh import Mesh
from .tiling import halo_exchange_rows

__all__ = ["stripe_guide", "crf_stereo_infer_tiled"]


def stripe_guide(stripe: torch.Tensor, row0: int, h: int, w: int,
                 cfg: CRFStereoConfig) -> torch.Tensor:
    """Guide [rgb/σc, ij/σp] of a padded (hh, w, 3) stripe whose first row
    is global row `row0`, positions over the global diagonal. Constant
    divisions are products with reciprocals, the two position scalings
    folded into one factor, as `crf.guides.stack_guide` builds them."""
    hh, ww = stripe.shape[:2]
    dt, dev = stripe.dtype, stripe.device

    def recip(x):
        return torch.reciprocal(torch.as_tensor(x, dtype=dt, device=dev))

    ii = (torch.arange(hh, dtype=dt, device=dev) + row0)[:, None].expand(hh, ww)
    jj = torch.arange(ww, dtype=dt, device=dev)[None, :].expand(hh, ww)
    pos = torch.stack([ii, jj], dim=-1) * (recip((h ** 2 + w ** 2) ** 0.5) * recip(cfg.sigma_pos))
    return torch.cat([stripe * recip(cfg.sigma_color), pos], dim=-1)


def crf_stereo_infer_tiled(left_local, right_local, cfg: CRFStereoConfig, mesh: Mesh,
                           halo: int = 16, axis: str = "tile", device=None) -> torch.Tensor:
    """This rank's (h_local, w) disparity stripe of the row-striped
    pipeline, from its (h_local, w, 3) stripes of the pair (rank t of
    `axis` holds rows t·h_local ... (t+1)·h_local − 1). Collective over the
    axis' ranks; `tiling.gather_rows` assembles the whole (h, w) map."""
    dev = resolve_device(device)
    left_l, right_l = _as_image(left_local, dev), _as_image(right_local, dev)
    local_h, w, _ = left_l.shape
    h = local_h * mesh.axis_size(axis)

    labels = torch.arange(cfg.num_disp, dtype=torch.float32, device=dev)
    Mu = compatibility_matrix(lambda a, b: charbonnier2(a, b, cfg.gamma), labels) * cfg.mu_scale

    lp = halo_exchange_rows(left_l, halo, mesh, axis)
    rp = halo_exchange_rows(right_l, halo, mesh, axis)
    hh, ww = lp.shape[:2]
    E0 = stereo_unary(lp, rp, cfg)  # (hh, ww, L)
    guide = stripe_guide(lp, mesh.axis_index(axis) * local_h - halo, h, w, cfg)

    ref = guide.reshape(hh * ww, -1)
    cap = cfg.max_vertices
    if cap is None:
        cap = min(1 << (2 * hh * ww - 1).bit_length(), hh * ww * (ref.shape[1] + 1))
    plan = build_plan(ref, max_vertices=cap)

    def message_fn(Q):
        return apply_plan(plan, Q) - Q

    Q = mean_field_infer(E0.reshape(hh * ww, -1), message_fn, Mu, cfg.niters)
    disp = expected_disparity(torch.log(Q + 1e-20)).reshape(hh, ww)
    return disp[halo:hh - halo]
