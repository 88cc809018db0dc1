"""State carried across from the JAX package: configs and parameters.

Every function takes plain Python and numpy values (a JAX dataclass, a
dict, arrays with `__array__`), so this module imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pipeline import CRFStereoConfig
from .device import resolve_device

__all__ = ["config_from_jax", "params_from_jax", "load_jax_params"]


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


def _flat_jax_tree(tree, prefix: str = "") -> dict:
    """{dotted name: array} of a params tree, in the port's names: flax's
    'params' collection level is dropped, conv `kernel` and GroupNorm
    `scale` leaves are named `weight`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        name = prefix[:-1]
        head, _, leaf = name.rpartition(".")
        if leaf in ("kernel", "scale"):
            name = f"{head}.weight" if head else "weight"
        return {name: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_jax_tree(v, prefix if k == "params" else f"{prefix}{k}."))
    return out


def load_jax_params(module: torch.nn.Module, tree, device=None) -> torch.nn.Module:
    """Copy a JAX params tree (numpy-convertible leaves) onto `module`'s
    parameters by name and move the module to `device` (None: the GPU).
    Four-dimensional leaves are convolution kernels and go from HWIO to
    OIHW. A leaf without a parameter, a parameter without a leaf, or a
    shape that does not match raises."""
    dev = resolve_device(device)
    flat = _flat_jax_tree(tree)
    params = dict(module.named_parameters())
    missing, extra = sorted(set(params) - set(flat)), sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"parameters without a leaf: {missing}; leaves without a "
                         f"parameter: {extra}")
    with torch.no_grad():
        for name, p in params.items():
            a = flat[name]
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: leaf shape {a.shape}, parameter {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(a), dtype=p.dtype))
    return module.to(dev)
