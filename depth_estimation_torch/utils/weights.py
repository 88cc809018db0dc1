"""State carried across from the JAX package: configs and parameters.

Both functions take plain Python and numpy values (a JAX dataclass, a
dict, arrays with `__array__`), so this module imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pipeline import CRFStereoConfig
from .device import resolve_device

__all__ = ["config_from_jax", "params_from_jax"]


def config_from_jax(cfg_or_dict) -> CRFStereoConfig:
    """The port's `CRFStereoConfig` from the JAX package's config (or its
    dict), field by field, calibrated capacities included."""
    if dataclasses.is_dataclass(cfg_or_dict):
        src = {f.name: getattr(cfg_or_dict, f.name) for f in dataclasses.fields(cfg_or_dict)}
    else:
        src = dict(cfg_or_dict)
    names = {f.name for f in dataclasses.fields(CRFStereoConfig)}
    unknown = sorted(set(src) - names)
    if unknown:
        raise ValueError(f"fields the port's CRFStereoConfig lacks: {unknown}")
    return CRFStereoConfig(**src)


def params_from_jax(tree, device=None):
    """A parameter pytree of arrays (nested dicts, lists, tuples) as the same
    structure of tensors on `device`, dtypes kept. `None` means the GPU, as
    for every entry point of the port: without one it raises."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, dev) for v in tree)
    return torch.as_tensor(np.array(tree), device=dev)
