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

Data parallel: pass a `parallel.mesh.Mesh` and every rank runs the same
program on its shard. Each rank receives the global batch and takes its
rows of every tensor leaf's leading axis; `init` broadcasts the parameters
from the 'data' axis' rank 0; after `backward` the gradients are averaged
over the axis before the optimizer step, so every rank takes the same
step. The logged loss and `evaluate`'s metrics are means over the ranks.
Only global rank 0 writes the log and checkpoints; `restore` loads on
every rank. As in the JAX package, the loss must average over the batch
(any `...mean()` loss does), so that the mean of the shards' gradients is
the full batch's.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh, all_mean_, broadcast_, shard_batch
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


def _map(fn: Callable, batch: Any) -> Any:
    """`fn` applied to every tensor of a (nested) batch."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return batch


class Trainer:
    """Minimal trainer.

    Args:
      loss_fn: (model, batch) → scalar loss tensor.
      make_optimizer: parameters → a `torch.optim.Optimizer`.
      metrics_fn: optional (model, batch) → dict of scalars, for evaluation.
      log_dir: where `train_log.jsonl` and `checkpoints/` go.
      lr_schedule: optional step ↦ learning rate (e.g. `cosine_lr`).
      mesh: optional `parallel.mesh.Mesh` with a 'data' axis: data-parallel
        updates (see the module docstring).
      device: where the model and batches go (None: the GPU).
    """

    def __init__(self, loss_fn: Callable, make_optimizer: Callable,
                 metrics_fn: Callable | None = None, log_dir: str | None = None,
                 log_every: int = 10, lr_schedule: Callable[[int], float] | None = None,
                 mesh: Mesh | None = None, device=None):
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.make_optimizer = make_optimizer
        self.metrics_fn = metrics_fn
        self.log_dir = Path(log_dir) if log_dir else None
        self.log_every = log_every
        self.lr_schedule = lr_schedule
        self.device = resolve_device(device)

    @property
    def _writes(self) -> bool:
        """Whether this rank writes the log and checkpoints."""
        return self.mesh is None or self.mesh.rank == 0

    def _place(self, batch):
        """This rank's shard of the batch (the whole batch without a mesh),
        on the device."""
        if self.mesh is not None:
            batch = _map(lambda x: shard_batch(x, self.mesh) if x.ndim >= 1 else x, batch)
        return _map(lambda x: x.to(self.device), batch)

    def _mean(self, values: list[torch.Tensor]) -> list[torch.Tensor]:
        return values if self.mesh is None else all_mean_(values, self.mesh)

    def init(self, model: torch.nn.Module) -> TrainState:
        model = model.to(self.device)
        if self.mesh is not None:
            broadcast_(list(model.parameters()) + list(model.buffers()), self.mesh)
        return TrainState(model, self.make_optimizer(model.parameters()), 0)

    def update(self, state: TrainState, batch) -> float:
        """One optimizer step on `batch` (this rank's shard of it under a
        mesh); returns the loss, averaged over the data ranks."""
        if self.lr_schedule is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = self.lr_schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(state.model, self._place(batch))
        loss.backward()
        self._mean([p.grad for p in state.model.parameters() if p.grad is not None])
        state.optimizer.step()
        state.step += 1
        return self._mean([loss.detach()])[0].item()

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
                loss = self.update(state, batch)
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
                for k, v in self.metrics_fn(state.model, self._place(batch)).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
        names = sorted(totals)
        local = torch.tensor([totals[k] / max(count, 1) for k in names], dtype=torch.float64,
                             device=self.device)
        means = dict(zip(names, self._mean([local])[0].tolist()))
        self._log({"step": state.step, "eval": means})
        return means

    def _log(self, record: dict) -> None:
        if self.log_dir and self._writes:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            with open(self.log_dir / "train_log.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")

    def _path(self, name: str) -> Path:
        if not self.log_dir:
            raise ValueError("Trainer needs log_dir for checkpointing")
        return self.log_dir / "checkpoints" / f"{name}.pt"

    def save(self, state: TrainState, name: str = "latest") -> None:
        """Rank 0 writes; with a mesh every rank waits for it, so that a
        `restore` that follows finds the file."""
        path = self._path(name)
        if self._writes:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({"model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(), "step": state.step}, path)
        if self.mesh is not None and self.mesh.backend is not None:
            dist.barrier()

    def restore(self, template: TrainState, name: str = "latest") -> TrainState:
        """Load a checkpoint into `template`'s model and optimizer."""
        ckpt = torch.load(self._path(name), map_location=self.device, weights_only=True)
        template.model.load_state_dict(ckpt["model"])
        template.optimizer.load_state_dict(ckpt["optimizer"])
        template.step = int(ckpt["step"])
        return template
