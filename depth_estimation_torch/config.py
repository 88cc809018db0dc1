"""Unified configuration: one dataclass tree for the whole stack (the port's
own copy of the JAX package's `config.py`, which is plain Python).

Typed frozen dataclasses with

- validation (`finalize()`),
- dict/JSON round trip (`to_dict`/`from_dict`, a partial nested dict merges
  onto the defaults),
- dotted-path overrides (`override(cfg, "crf.niters", 8)`).

The fields and defaults are the JAX package's, so both packages read the
same JSON into equal configs. Validation raises `ValueError`, which
`python -O` keeps.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "CRFConfig",
    "UnaryConfig",
    "MeshConfig",
    "TrainConfig",
    "ExperimentConfig",
    "to_dict",
    "from_dict",
    "override",
]


@dataclass(frozen=True)
class UnaryConfig:
    """Cost-volume construction."""

    num_disp: int = 16
    window_size: int = 9
    criterion: str = "ad"  # 'ad' | 'sd' | 'nprod'


@dataclass(frozen=True)
class CRFConfig:
    """Mean-field CRF and its message-passing backend."""

    niters: int = 5
    gamma: float = 3.0
    sigma_color: float = 0.1
    sigma_pos: float = 0.1
    sigma_feat: float = 10.0
    backend: str = "lattice"  # 'lattice' | 'dense' | 'guided'
    guided_radius: int = 15
    guided_eps: float = 1e-2
    max_vertices: int | None = None  # None = auto (pow2 ≥ 2n)


@dataclass(frozen=True)
class MeshConfig:
    """Process mesh (`parallel.mesh.make_mesh`) and the tiled halo."""

    data: int | None = None  # None = all ranks / tile
    tile: int = 1
    halo: int = 8


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 300
    lr: float = 3e-2
    schedule: str = "constant"  # 'constant' | 'cosine'
    log_every: int = 10
    eval_every: int = 100
    seed: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    unary: UnaryConfig = field(default_factory=UnaryConfig)
    crf: CRFConfig = field(default_factory=CRFConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def finalize(self) -> "ExperimentConfig":
        """Validate; returns the config itself."""
        checks = {
            "unary.num_disp > 0": self.unary.num_disp > 0,
            "odd unary.window_size": self.unary.window_size % 2 == 1,
            "crf.backend in lattice, dense, guided": self.crf.backend in ("lattice", "dense",
                                                                          "guided"),
            "crf.niters >= 0": self.crf.niters >= 0,
            "mesh.tile >= 1 and mesh.halo >= 1": self.mesh.tile >= 1 and self.mesh.halo >= 1,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise ValueError(f"invalid config: {', '.join(failed)}")
        return self


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _build(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            v = _build(f.type, v)
        elif isinstance(v, dict):
            sub = {
                "unary": UnaryConfig,
                "crf": CRFConfig,
                "mesh": MeshConfig,
                "train": TrainConfig,
            }.get(f.name)
            if sub:
                v = _build(sub, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def from_dict(data: dict) -> ExperimentConfig:
    """Merge a (possibly partial, nested) dict onto defaults."""
    return _build(ExperimentConfig, data).finalize()


def from_json(path) -> ExperimentConfig:
    with open(path) as f:
        return from_dict(json.load(f))


def override(cfg, path: str, value: Any):
    """A copy of `cfg` with the dotted-path field replaced
    (`override(cfg, 'crf.niters', 8)`)."""
    parts = path.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    head, rest = parts[0], ".".join(parts[1:])
    return dataclasses.replace(cfg, **{head: override(getattr(cfg, head), rest, value)})
