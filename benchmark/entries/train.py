"""End-to-end training of the CRF: one `CRFasRNN(backend="lattice")`
forward, backward and Adam step per pool pair, in turn, on the masked mean
squared error of the expected disparity against the pair's ground truth
where it is known (gt > 0). The pool's unary logits are made in set-up, as
a training loop makes them before it starts; the lattice options are
calibrated once on the first pair's guide at the initial scales.

Set-up drives the one model and optimizer through the first `ref_steps`
steps by the window's own call, on pairs that all differ, and keeps each
step's loss, the first gradient as Adam holds it after one step, and the
parameters before each step and as step `ref_steps` + 1 finds them; the
window goes on with the same objects. The plain reference follows the
program's state step by step (the loss and gradient of step t at the
parameters the program held before it, the first step at the
configuration's initial ones), since a parameter one rounding apart
moves positions across a simplex's face and changes the lattice; the
comparison holds the program's steps against it:

- `loss_gap`: the largest |loss − reference| / |reference| of those steps;
- `grad_gap`: over the parameters, the largest gap between the norms of
  the program's and the reference's first gradient, against the larger of
  the reference's norm of that parameter and the median parameter's;
- `update_gap`: the same of the parameters' change over the steps (the
  reference's: its own Adam steps on its own gradients), over the
  parameters whose reference gradient is at least a thousandth of the
  median parameter's.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from depth_estimation_torch.crf.guides import ijrgb_guide
from depth_estimation_torch.models.pipeline import CRFStereoConfig, blocked, stereo_unary
from depth_estimation_torch.models.refiner import CRFasRNN
from depth_estimation_torch.ops.costvolume import expected_disparity
from depth_estimation_torch.ops.permutohedral import (suggest_capacity, suggest_sort_mode,
                                                      suggest_tile_u)
from depth_estimation_torch.train.metrics import masked_mse

from ..frames import make_pool
from ..reference.crf_train import NAMES, train_steps


def _gap(mine: dict, ref: dict, names) -> float:
    """The largest |‖mine‖ − ‖ref‖| over `names`, each against the larger of
    its own reference norm and the median one."""
    norms = {k: float(ref[k].norm()) for k in names}
    median = statistics.median(norms.values())
    return max(abs(float(mine[k].norm()) - norms[k]) / max(norms[k], median) for k in names)


class Entry:
    frames_per_unit = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        tr = config["train"]
        t = time.perf_counter()
        self.pool = make_pool(seed, traffic["pool"], config["height"], config["width"],
                              traffic["num_layers"], traffic["max_disp"], traffic["contrast"],
                              device)
        self.timings = {"pool_s": time.perf_counter() - t}
        t = time.perf_counter()
        unary = CRFStereoConfig(num_disp=config["num_disp"], window_size=config["window_size"])
        self.logits = [-stereo_unary(self.pool.left[k], self.pool.right[k], unary)
                       for k in range(traffic["pool"])]
        self.masks = (self.pool.gt > 0).float()
        self.timings["unary_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.model = CRFasRNN(gamma=tr["init"]["mu.gamma"], backend="lattice", device=device)
        self.p0 = {k: p.detach().double().cpu().clone() for k, p in self.model.named_parameters()}
        if any(not math.isclose(float(self.p0[k]), v, rel_tol=1e-6, abs_tol=1e-12)
               for k, v in tr["init"].items()) or set(self.p0) != set(NAMES):
            raise ValueError(f"CRFasRNN starts at {self.p0}, the configuration at {tr['init']}")
        self.opt = torch.optim.Adam(self.model.parameters(), lr=tr["lr"],
                                    betas=tuple(tr["betas"]), eps=tr["eps"])
        guide = ijrgb_guide(self.model.w, self.pool.left[0]).detach()
        ref0 = guide.reshape(-1, guide.shape[-1])
        cap = suggest_capacity(ref0, headroom=tr["capacity_headroom"])
        B = tr["tile_px"]
        self.plan = dict(max_vertices=cap, tile_px=B, tile_bf16=tr["tile_bf16"],
                         sort_mode=suggest_sort_mode(ref0),
                         tile_u=suggest_tile_u(blocked(guide, B), B * B, cap,
                                               headroom=tr["tile_u_headroom"]))
        self.timings["model_and_calibration_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.bad = 0
        self.losses = []
        self.grad1 = None
        self.p_steps = [self.p0]  # the parameters before each step, and after the last
        for i in range(traffic["ref_steps"]):
            self.unit(i)
            self.p_steps.append({k: p.detach().double().cpu().clone()
                                 for k, p in self.model.named_parameters()})
            if i == 0:
                b1 = tr["betas"][0]
                # an optimizer that kept no state gives no gradient to compare
                nan = torch.tensor(float("nan"), dtype=torch.float64)
                self.grad1 = {k: self.opt.state[p]["exp_avg"].detach().double().cpu() / (1 - b1)
                              if "exp_avg" in self.opt.state[p] else nan
                              for k, p in self.model.named_parameters()}
        self.first_losses = list(self.losses)
        self.next_unit = traffic["ref_steps"]
        self.timings["first_steps_s"] = time.perf_counter() - t
        self.losses.clear()
        self.bad = 0

    def warm(self) -> None:
        """The first steps of set-up ran every shape of the step."""

    def unit(self, i: int) -> None:
        k = i % self.traffic["pool"]
        self.opt.zero_grad(set_to_none=True)
        refined = self.model(self.pool.left[k], self.logits[k], niters=self.config["niters"],
                             **self.plan)
        loss = masked_mse(expected_disparity(refined), self.pool.gt[k], self.masks[k])
        loss.backward()
        self.opt.step()
        value = loss.item()
        self.losses.append(value)
        self.bad += not math.isfinite(value)

    def failed(self) -> int:
        return self.bad

    def end_to_end(self, window_s: float, latencies: list, units: int) -> dict:
        return {"train_step_ms": window_s / units * 1e3}

    def summary(self) -> str:
        params = {k: round(float(p.detach()), 6) for k, p in self.model.named_parameters()}
        return (f"plan {self.plan}; first losses {self.first_losses}; last loss "
                f"{self.losses[-1] if self.losses else None}; parameters now {params}")

    def release(self) -> None:
        self.model = self.opt = None
        self.logits = None

    def _numbers(self, losses, grad1, p0, p_after, ref) -> dict:
        """The three numbers of (losses, first gradient, parameters before
        and after the steps) against the reference's steps `ref`."""
        g_ref = {k: v.cpu() for k, v in ref["grads"].items()}
        median = statistics.median(float(g_ref[k].norm()) for k in NAMES)
        moving = [k for k in NAMES if float(g_ref[k].norm()) >= 1e-3 * median]
        d_mine = {k: p_after[k].cpu() - p0[k].cpu() for k in NAMES}
        d_ref = {k: ref["change"][k].cpu() for k in NAMES}
        self.detail = {"losses": list(losses), "reference_losses": ref["losses"],
                       "grad": {k: float(grad1[k]) for k in NAMES},
                       "reference_grad": {k: float(g_ref[k]) for k in NAMES},
                       "change": {k: float(d_mine[k]) for k in NAMES},
                       "reference_change": {k: float(d_ref[k]) for k in NAMES}}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
                "grad_gap": _gap(grad1, g_ref, NAMES),
                "update_gap": _gap(d_mine, d_ref, moving)}

    def _reference(self, **how) -> dict:
        pairs = [(self.pool.left[k], self.pool.right[k], self.pool.gt[k])
                 for k in range(self.traffic["ref_steps"])]
        return train_steps(pairs, self.config, self.config["train"]["init"],
                           self.config["train"], **how)

    def check(self) -> dict:
        return self._numbers(self.first_losses, self.grad1, self.p_steps[0], self.p_steps[-1],
                             self._reference(follow=self.p_steps[:-1]))

    def control(self) -> dict:
        """The reference in float32 with TF32 products in the program's
        place, on its own trajectory, against the reference following it."""
        low = self._reference(dtype=torch.float32, tf32=True)
        p0 = {k: torch.tensor(float(torch.tensor(v, dtype=torch.float32)), dtype=torch.float64)
              for k, v in self.config["train"]["init"].items()}
        states = [p0] + low["params"]
        return self._numbers(low["losses"], {k: v.cpu() for k, v in low["grads"].items()}, p0,
                             states[-1], self._reference(follow=states[:-1]))
