"""Training harness: optimizer steps, a JSONL metric log, checkpoints
(counterpart of the JAX package's `train/trainer.py`).

- `TrainState`: the model, its optimizer and the step count.
- `Trainer`: updates over a user loss, an optional learning-rate schedule
  set on the optimizer before each step, one JSON line per log event
  (`train_log.jsonl`: `step`, `loss`, `steps_per_s`; `eval`; `interrupted`),
  periodic evaluation, `torch.save` checkpoints of model, optimizer and
  step, and a checkpoint when SIGINT interrupts `fit`.
- `cosine_lr`: cosine decay to zero, equal to
  `optax.cosine_decay_schedule(base, T)` at every step.

Data parallelism (`mesh`) is not ported yet: it comes with
`torch.distributed` (ROADMAP.md, slice 3).
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from ..utils.device import resolve_device

__all__ = ["TrainState", "Trainer", "cosine_lr"]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def cosine_lr(base_lr: float, total_steps: int) -> Callable[[int], float]:
    """step ↦ base_lr · ½(1 + cos(π·min(step, T)/T)), T = max(total_steps, 1)."""
    T = max(total_steps, 1)

    def schedule(step: int) -> float:
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * min(step, T) / T))

    return schedule


def _to(batch: Any, dev: torch.device) -> Any:
    """Tensors of a (nested) batch moved to `dev`."""
    if isinstance(batch, torch.Tensor):
        return batch.to(dev)
    if isinstance(batch, dict):
        return {k: _to(v, dev) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to(v, dev) for v in batch)
    return batch


class Trainer:
    """Minimal trainer.

    Args:
      loss_fn: (model, batch) → scalar loss tensor.
      make_optimizer: parameters → a `torch.optim.Optimizer`.
      metrics_fn: optional (model, batch) → dict of scalars, for evaluation.
      log_dir: where `train_log.jsonl` and `checkpoints/` go.
      lr_schedule: optional step ↦ learning rate (e.g. `cosine_lr`).
      mesh: data parallelism; not ported yet (raises).
      device: where the model and batches go (None: the GPU).
    """

    def __init__(self, loss_fn: Callable, make_optimizer: Callable,
                 metrics_fn: Callable | None = None, log_dir: str | None = None,
                 log_every: int = 10, lr_schedule: Callable[[int], float] | None = None,
                 mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel training is not ported yet: it comes with "
                "torch.distributed (ROADMAP.md, slice 3)")
        self.loss_fn = loss_fn
        self.make_optimizer = make_optimizer
        self.metrics_fn = metrics_fn
        self.log_dir = Path(log_dir) if log_dir else None
        self.log_every = log_every
        self.lr_schedule = lr_schedule
        self.device = resolve_device(device)

    def init(self, model: torch.nn.Module) -> TrainState:
        model = model.to(self.device)
        return TrainState(model, self.make_optimizer(model.parameters()), 0)

    def _update(self, state: TrainState, batch) -> float:
        if self.lr_schedule is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = self.lr_schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(state.model, _to(batch, self.device))
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.item()

    def fit(self, state: TrainState, batches, num_steps: int, eval_batches=None,
            eval_every: int = 100) -> TrainState:
        """`num_steps` updates pulling batches from the (cycling) iterable;
        logs the loss and periodic evaluation metrics."""
        it = iter(batches)
        t0 = time.time()
        try:
            for i in range(num_steps):
                try:
                    batch = next(it)
                except StopIteration:
                    it = iter(batches)
                    batch = next(it)
                loss = self._update(state, batch)
                if (i + 1) % self.log_every == 0 or i == num_steps - 1:
                    self._log({"step": state.step, "loss": loss,
                               "steps_per_s": (i + 1) / (time.time() - t0)})
                if eval_batches is not None and (i + 1) % eval_every == 0:
                    self.evaluate(state, eval_batches)
        except KeyboardInterrupt:
            if self.log_dir:
                self.save(state, name="interrupt")
                self._log({"step": state.step, "interrupted": True})
            raise
        return state

    def evaluate(self, state: TrainState, batches) -> dict:
        if self.metrics_fn is None:
            return {}
        totals, count = {}, 0
        with torch.no_grad():
            for batch in batches:
                for k, v in self.metrics_fn(state.model, _to(batch, self.device)).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
        means = {k: v / max(count, 1) for k, v in totals.items()}
        self._log({"step": state.step, "eval": means})
        return means

    def _log(self, record: dict) -> None:
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            with open(self.log_dir / "train_log.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")

    def _path(self, name: str) -> Path:
        if not self.log_dir:
            raise ValueError("Trainer needs log_dir for checkpointing")
        return self.log_dir / "checkpoints" / f"{name}.pt"

    def save(self, state: TrainState, name: str = "latest") -> None:
        path = self._path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, path)

    def restore(self, template: TrainState, name: str = "latest") -> TrainState:
        """Load a checkpoint into `template`'s model and optimizer."""
        ckpt = torch.load(self._path(name), map_location=self.device, weights_only=True)
        template.model.load_state_dict(ckpt["model"])
        template.optimizer.load_state_dict(ckpt["optimizer"])
        template.step = int(ckpt["step"])
        return template
