"""A stream of small frames through `StereoServer`: one client in a closed
loop sends batches of consecutive pool frames and fetches each (B, h, w)
result to the host before the next call. The server calibrates itself on
its first batch (`auto_capacity`)."""
from __future__ import annotations

import torch

from depth_estimation_torch.models.serving import StereoServer

from ..harness import p95
from .infer import InferEntry, program_config

# what `StereoServer(auto_capacity=True)` calibrates with; a configuration
# that states another calibration cannot be served by it
SERVER_CALIBRATION = {"headroom": 3.0, "tiled": True, "tile_px": 32,
                      "max_incidence_bytes": 1 << 30}


class Entry(InferEntry):
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        if config["infer"]["calibrate"] != SERVER_CALIBRATION:
            raise ValueError(f"StereoServer calibrates as {SERVER_CALIBRATION}, the "
                             f"configuration states {config['infer']['calibrate']}")
        self.batch = traffic["batch"]
        if traffic["pool"] % self.batch:
            raise ValueError("the pool must hold whole batches")
        self.frames_per_unit = self.batch
        self.server = StereoServer(program_config(config), auto_capacity=True, device=device)

    def program_state(self):
        return self.cfg if self.server is None else self.server.cfg

    def unit(self, i: int) -> None:
        first = (i % (self.traffic["pool"] // self.batch)) * self.batch
        rows = slice(first, first + self.batch)
        out = self.server(self.pool.left[rows], self.pool.right[rows])
        self.flags.append(torch.isfinite(out).all())
        host = out.cpu()
        for j in range(self.batch):
            self.keep(first + j, host[j])

    def end_to_end(self, window_s: float, latencies: list, units: int) -> dict:
        return {"batch_ms_p95": p95(latencies) * 1e3}

    def release(self) -> None:
        self.flags = [bool(f) for f in self.flags]
        self.cfg, self.server = self.server.cfg, None
