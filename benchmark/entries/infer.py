"""What the inference entries share: the pool of pairs, the program's
configuration, the answers kept for the comparison, and the comparison.

The comparison: for each pair of a sample of the pool drawn from the seed,
the first and the last disparity map the client fetched for it after the
warm-up, each against the plain reference's map of that pair;
`disp_gap_px` is the mean absolute gap over all their pixels. Pooled, not
the worst map's: under a bf16 state a region of near-tied labels can tip
over as a whole in one frame in a few hundred (PERF.md, §2).
"""
from __future__ import annotations

import time

import torch

from depth_estimation_torch.models.pipeline import CRFStereoConfig
from depth_estimation_torch.ops.cuda import meanfield as K

from ..frames import make_pool
from ..reference import stereo

__all__ = ["InferEntry", "program_config"]

# the next precision below a configuration's mean-field state, for the control
LOWER = {"bf16": torch.float8_e4m3fn}
CRF_KEYS = ("num_disp", "window_size", "gamma", "sigma_color", "sigma_pos", "niters",
            "mu_scale")


def program_config(config: dict) -> CRFStereoConfig:
    """The program's configuration before calibration."""
    infer = config["infer"]
    return CRFStereoConfig(**{k: config[k] for k in CRF_KEYS}, tile_bf16=infer["tile_bf16"],
                           compute_dtype=infer["compute_dtype"],
                           fused_update=infer["fused_update"])


class InferEntry:
    frames_per_unit = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        t = time.perf_counter()
        self.pool = make_pool(seed, traffic["pool"], config["height"], config["width"],
                              traffic["num_layers"], traffic["max_disp"], traffic["contrast"],
                              device)
        self.timings = {"pool_s": time.perf_counter() - t}
        gen = torch.Generator().manual_seed(seed)
        ids = torch.randperm(traffic["pool"], generator=gen)[: traffic["check_frames"]]
        self.answers = {k: [] for k in sorted(ids.tolist())}
        self.flags = []  # one device bool a unit: its outputs finite, nothing dropped
        self.next_unit = 0
        self.launches = K.launch_counts()

    def keep(self, k: int, host: torch.Tensor) -> None:
        """Keep the first and the latest answer for pool pair k."""
        kept = self.answers.get(k)
        if kept is None:
            return
        if len(kept) < 2:
            kept.append(host)
        else:
            kept[1] = host

    def warm(self) -> None:
        """One pass over the pool's shapes; what it produced is not judged."""
        for i in range(self.traffic["warm_units"]):
            self.unit(i)
        self.next_unit = self.traffic["warm_units"]
        for kept in self.answers.values():
            kept.clear()
        self.flags.clear()
        self.launches = K.launch_counts()

    def failed(self) -> int:
        return sum(int(not bool(f)) for f in self.flags) * self.frames_per_unit

    def program_state(self) -> CRFStereoConfig:
        raise NotImplementedError

    def summary(self) -> str:
        now = K.launch_counts()
        launched = {k: now[k] - self.launches[k] for k in now if now[k] != self.launches[k]}
        c = self.program_state()
        return (f"calibrated max_vertices={c.max_vertices} sort_mode={c.sort_mode} "
                f"tile_px={c.tile_px} tile_u={c.tile_u} tile_bf16={c.tile_bf16} "
                f"compute_dtype={c.compute_dtype} fused_update={c.fused_update}; "
                f"kernel launches after the warm-up {launched}")

    def _gaps(self, answers=None) -> dict:
        gaps, self.detail = [], []
        for k, kept in self.answers.items():
            left, right = self.pool.left[k], self.pool.right[k]
            ref = stereo.disparity(left, right, self.config).cpu()
            mine = kept if answers is None else [answers(left, right).cpu()]
            for a in mine:
                gap = (a.double() - ref).abs()
                gaps.append(float(gap.mean()))
                q = torch.quantile(gap.flatten()[:: max(1, gap.numel() // 1_000_000)],
                                   torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
                self.detail.append({"pair": k, "mean": gaps[-1], "p50": float(q[0]),
                                    "p90": float(q[1]), "p99": float(q[2]), "max": float(gap.max()),
                                    "over_1px": float((gap > 1).double().mean())})
            if not mine:  # a pair the window never answered fails the comparison
                gaps.append(float("nan"))
        return {"disp_gap_px": sum(gaps) / len(gaps)}

    def check(self) -> dict:
        return self._gaps()

    def control(self) -> dict:
        """The reference at the next precision below the configuration's
        state (and its incidence blocks, where tiled in bf16) in the
        program's place."""
        c = self.program_state()
        low = LOWER[c.compute_dtype]
        blocks = low if (c.tile_px is not None and c.tile_bf16) else None
        return self._gaps(answers=lambda left, right: stereo.disparity(
            left, right, self.config, state=low, blocks=blocks))
