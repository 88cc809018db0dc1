"""Batched stereo serving: frames → disparities (counterpart of the JAX
package's `models/serving.py`).

    server = StereoServer(cfg)                   # or mesh=make_mesh(...)
    disps = server(left_batch, right_batch)      # (B, h, w) on the device
    stats = server.throughput(left_batch, right_batch)

The batch moves to the device once; each frame runs `crf_stereo_infer`
with the server's config (with `fused_update`, 5 launches of the fused
mean-field kernel a frame) and the results are stacked on the device. With
a mesh, each rank of the 'data' axis serves its rows of the batch and the
whole (B, h, w) result is gathered on every rank.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import Mesh, shard_batch
from ..parallel.tiling import gather_rows
from ..utils.device import resolve_device
from ..utils.timing import chain_timer
from .pipeline import CRFStereoConfig, _as_image, calibrate_capacity, crf_stereo_infer

__all__ = ["StereoServer"]


class StereoServer:
    def __init__(self, cfg: CRFStereoConfig, mesh: Mesh | None = None,
                 auto_capacity: bool = True, batch_mode: str = "loop", device=None):
        """`auto_capacity` (default on): when the lattice backend runs with
        no explicit `max_vertices`, the first batch's leading frame
        calibrates the capacity, sort mode and tiles
        (`pipeline.calibrate_capacity(..., tiled=True)`). A later frame
        whose packed key does not fit that calibration raises, as
        `build_plan` does.

        `batch_mode`: 'loop' (default) or 'vmap'. The JAX package's 'vmap'
        maps one program over the batch; `torch.func.vmap` cannot map the
        plan build (its shapes depend on the data and it reads values on
        the host), so here 'vmap' runs the same per-frame program as
        'loop' and gives the same results."""
        if batch_mode not in ("loop", "vmap"):
            raise ValueError(f"unknown batch_mode {batch_mode!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.batch_mode = batch_mode
        self.device = resolve_device(device)
        self._needs_calibration = (
            auto_capacity and cfg.backend == "lattice" and cfg.max_vertices is None)

    def _serve(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            left, right = shard_batch(left, self.mesh), shard_batch(right, self.mesh)
        out = torch.stack([crf_stereo_infer(left[i], right[i], self.cfg,
                                            device=self.device)["disparity"]
                           for i in range(left.shape[0])])
        return out if self.mesh is None else gather_rows(out, self.mesh, axis="data")

    def _calibrate(self, left: torch.Tensor) -> None:
        if self._needs_calibration:
            self.cfg = calibrate_capacity(left[0], self.cfg, tiled=True, device=self.device)
            self._needs_calibration = False

    def __call__(self, left_batch, right_batch) -> torch.Tensor:
        left = _as_image(left_batch, self.device)
        self._calibrate(left)
        return self._serve(left, _as_image(right_batch, self.device))

    def throughput(self, left_batch, right_batch, reps: int = 5) -> dict:
        """Steady-state frames/s of whole batches, by `utils.timing.chain_timer`
        (each rep folds its disparities into a device scalar)."""
        left, right = _as_image(left_batch, self.device), _as_image(right_batch, self.device)
        self._calibrate(left)

        def step(acc):
            return acc + self._serve(left, right).sum(dtype=torch.float32)

        dt = chain_timer(step, reps=reps, device=self.device)
        B = left.shape[0]
        return {
            "frames_per_s": B / dt,
            "batch": B,
            "ms_per_batch": dt * 1e3,
            "devices": 1 if self.mesh is None else self.mesh.axis_size("data"),
        }
