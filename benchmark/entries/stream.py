"""One large frame at a time: a closed loop of `crf_stereo_infer` over
the pool, each disparity fetched to the host before the next frame. The
configuration is calibrated once, on the stream's first frame, as a user
of `crf_stereo_infer` does."""
from __future__ import annotations

import time

import torch

from depth_estimation_torch.models.pipeline import calibrate_capacity, crf_stereo_infer

from .infer import InferEntry, program_config


class Entry(InferEntry):
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        t = time.perf_counter()
        self.cfg = calibrate_capacity(self.pool.left[0], program_config(config), device=device,
                                      **config["infer"]["calibrate"])
        self.timings["calibrate_s"] = time.perf_counter() - t

    def program_state(self):
        return self.cfg

    def unit(self, i: int) -> None:
        k = i % self.traffic["pool"]
        out = crf_stereo_infer(self.pool.left[k], self.pool.right[k], self.cfg,
                               device=self.device)
        disp = out["disparity"]
        ok = torch.isfinite(disp).all()
        for plan in out["plans"]:
            ok = ok & (plan.num_valid <= plan.capacity)
            if plan.tile_overflow is not None:
                ok = ok & (plan.tile_overflow == 0)
        self.flags.append(ok)
        self.keep(k, disp.cpu())

    def end_to_end(self, window_s: float, latencies: list, units: int) -> dict:
        return {"frames_per_s": units / window_s}

    def release(self) -> None:
        self.flags = [bool(f) for f in self.flags]
