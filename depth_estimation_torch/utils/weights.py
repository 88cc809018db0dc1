"""State carried across from the JAX package, and pretrained-weight import.

- `config_from_jax`, `params_from_jax`: configs and parameter pytrees.
- `load_jax_params` / `state_dict_from_jax`: a flax params tree onto a
  module by name. Each leaf's layout follows the kind of layer it belongs
  to, never its number of dimensions: an `nn.Linear` weight is the flax
  `Dense` kernel (in, out) transposed; an `nn.Conv2d` weight is the HWIO
  kernel as OIHW; an `nn.ConvTranspose2d` weight is the flax kernel
  (kh, kw, in, out) flipped in both spatial axes (flax does not flip it,
  torch's transposed convolution does) and laid out (in, out, kh, kw).
  GroupNorm, `AffineChannel` and plain parameters are copied as they are,
  unless a module declares another layout for a parameter in its
  `JAX_LAYOUTS` ({name: 'dense' | 'conv' | 'conv_transpose'}).
- The pretrained importers (Detectron pkl, Matterport Keras h5, torchvision
  state dicts, torchvision VGG16) and `graft_backbone`. Each yields the
  port's state dict directly: for the detection `ResNet(norm='affine')`
  (`models/detection/backbone.py`; frozen BatchNorm as a per-channel
  affine, raw BN statistics folded by `fold_batchnorm`) or for
  `models.features.VGG16Features`. h5py is imported only by the h5 loader.

Every function takes plain Python and numpy values, so this module imports
nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..models.pipeline import CRFStereoConfig
from .device import resolve_device

__all__ = [
    "JAX_ONLY_FIELDS",
    "config_from_jax",
    "params_from_jax",
    "load_jax_params",
    "state_dict_from_jax",
    "fold_batchnorm",
    "resnet_import_kwargs",
    "load_detectron_pkl",
    "detectron_resnet_params",
    "load_keras_h5",
    "keras_resnet_params",
    "load_torch_state_dict",
    "torch_resnet_params",
    "torch_vgg16_params",
    "graft_backbone",
]


# fields of the JAX package's CRFStereoConfig that the port does not run
JAX_ONLY_FIELDS = ("max_pieces", "unroll")


def config_from_jax(cfg_or_dict) -> CRFStereoConfig:
    """The port's `CRFStereoConfig` from the JAX package's config (or its
    dict), field by field, calibrated capacities included.

    The fields in `JAX_ONLY_FIELDS` are dropped; any other field the port
    lacks raises. Dropping them keeps the answer: `unroll` chooses how XLA
    emits the mean-field loop, and the piece splat that `max_pieces` turns
    on (untiled) computes the entry splat's sums, except that pieces beyond
    `max_pieces` drop their mass, which the port's splat never does. With
    tiles and a pinned 'packed1', `max_pieces` also kept the JAX package on
    its general tiled build where the port takes the lean one; the two
    agree unless tiles overflow `tile_u`."""
    if dataclasses.is_dataclass(cfg_or_dict):
        src = {f.name: getattr(cfg_or_dict, f.name) for f in dataclasses.fields(cfg_or_dict)}
    else:
        src = dict(cfg_or_dict)
    src = {k: v for k, v in src.items() if k not in JAX_ONLY_FIELDS}
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


def _layout(module: nn.Module, pname: str) -> str | None:
    """How the flax leaf of `module`'s parameter `pname` maps onto it."""
    declared = getattr(module, "JAX_LAYOUTS", {}).get(pname)
    if declared is not None or pname != "weight":
        return declared
    if isinstance(module, nn.Linear):
        return "dense"
    if isinstance(module, nn.ConvTranspose2d):
        return "conv_transpose"
    if isinstance(module, nn.Conv2d):
        return "conv"
    return None


def _to_torch_layout(a: np.ndarray, layout: str | None) -> np.ndarray:
    if layout == "dense":
        return a.T
    if layout == "conv":
        return a.transpose(3, 2, 0, 1)
    if layout == "conv_transpose":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a


def state_dict_from_jax(module: nn.Module, tree) -> dict:
    """{parameter name: CPU tensor in the parameter's dtype} of a JAX params
    tree for `module`, each leaf in the layout of its layer's kind. A leaf
    without a parameter, a parameter without a leaf, or a shape that does
    not match raises."""
    flat = _flat_jax_tree(tree)
    owners = {f"{mname}.{pname}" if mname else pname: (m, pname)
              for mname, m in module.named_modules() for pname, _ in m.named_parameters(recurse=False)}
    params = dict(module.named_parameters())
    missing, extra = sorted(set(params) - set(flat)), sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"parameters without a leaf: {missing}; leaves without a "
                         f"parameter: {extra}")
    out = {}
    for name, p in params.items():
        a = _to_torch_layout(flat[name], _layout(*owners[name]))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: leaf shape {a.shape}, parameter {tuple(p.shape)}")
        out[name] = torch.as_tensor(np.array(a), dtype=p.dtype)
    return out


def load_jax_params(module: nn.Module, tree, device=None) -> nn.Module:
    """Copy a JAX params tree (numpy-convertible leaves) onto `module`'s
    parameters by name (`state_dict_from_jax`) and move the module to
    `device` (None: the GPU)."""
    dev = resolve_device(device)
    sd = state_dict_from_jax(module, tree)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(sd[name])
    return module.to(dev)


# ---------------------------------------------------------------------------
# pretrained backbones
# ---------------------------------------------------------------------------


def resnet_import_kwargs(source: str) -> dict:
    """`ResNet`/`MaskRCNN` backbone kwargs under which weights from `source`
    reproduce the source network: frozen affine norms, and the stride on
    the first 1×1 for Detectron (`RESNETS.STRIDE_1X1`) and Matterport Keras
    (`conv_block`), on the 3×3 for torchvision."""
    if source not in ("detectron", "keras", "torch"):
        raise ValueError(f"unknown weight source {source!r}")
    return {"norm": "affine", "stride_1x1": source in ("detectron", "keras")}


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5, conv_bias=None):
    """Fold BN statistics (and a preceding conv bias) into a frozen
    per-channel affine: BN(conv(x) + b) == scale·conv(x) + bias."""
    gamma, beta = np.asarray(gamma), np.asarray(beta)
    mean, var = np.asarray(mean), np.asarray(var)
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    if conv_bias is not None:
        bias = bias + np.asarray(conv_bias) * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


def _resnet_state(stem_w, stem_aff, blocks_params) -> dict:
    """The `ResNet(norm='affine')` state dict from the OIHW stem kernel, its
    (scale, bias) and per bottleneck a list of (OIHW kernel, (scale, bias))
    in the order branch a, b, c, then the projection shortcut."""
    sd = {"Conv_0.weight": _t(stem_w), "AffineChannel_0.weight": _t(stem_aff[0]),
          "AffineChannel_0.bias": _t(stem_aff[1])}
    for i, convs in enumerate(blocks_params):
        for k, (w, (scale, bias)) in enumerate(convs):
            p = f"Bottleneck_{i}"
            sd[f"{p}.Conv_{k}.weight"] = _t(w)
            sd[f"{p}.AffineChannel_{k}.weight"] = _t(scale)
            sd[f"{p}.AffineChannel_{k}.bias"] = _t(bias)
    return sd


def load_detectron_pkl(path) -> dict:
    """A Detectron weights pickle → flat blob name → np.ndarray (latin1
    encoding, optional 'blobs' wrapper). Unpickling runs code: load only
    files from a source you trust."""
    with open(path, "rb") as fp:
        blobs = pickle.load(fp, encoding="latin1")
    if "blobs" in blobs:
        blobs = blobs["blobs"]
    return {k: np.asarray(v) for k, v in blobs.items() if isinstance(v, np.ndarray)}


def detectron_resnet_params(blobs: Mapping[str, np.ndarray],
                            blocks: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """Caffe2 ResNet blobs (`res{s}_{j}_branch2{a,b,c}_w/_bn_s/_bn_b`, stem
    `conv1_w`/`res_conv1_bn_{s,b}`; BN already folded) as a `ResNet` state
    dict. Build the model with `resnet_import_kwargs('detectron')`."""
    out = []
    for stage, nblocks in enumerate(blocks):
        for j in range(nblocks):
            p = f"res{stage + 2}_{j}_branch"
            names = [f"{p}2{c}" for c in "abc"] + ([f"{p}1"] if f"{p}1_w" in blobs else [])
            out.append([(blobs[f"{n}_w"], (blobs[f"{n}_bn_s"], blobs[f"{n}_bn_b"])) for n in names])
    return _resnet_state(blobs["conv1_w"], (blobs["res_conv1_bn_s"], blobs["res_conv1_bn_b"]), out)


def load_keras_h5(path) -> dict:
    """An h5 weights file → flat `path/to/dataset` → array (weights files and
    full-model files with a `model_weights` group alike)."""
    import h5py

    flat: dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            flat[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return flat


def _keras_find(flat: Mapping[str, np.ndarray], layer: str, leaf: str) -> np.ndarray:
    hits = [k for k in flat if f"/{layer}/" in f"/{k}" and k.rsplit("/", 1)[-1].startswith(leaf)]
    if not hits:
        raise KeyError(f"no '{leaf}' weight for layer '{layer}' in h5 file")
    return flat[sorted(hits, key=len)[0]]


def keras_resnet_params(flat: Mapping[str, np.ndarray], blocks: Sequence[int] = (3, 4, 6, 3),
                        eps: float = 1e-3) -> dict:
    """Matterport Keras ResNet weights (`conv1`/`bn_conv1`,
    `res{s}{letter}_branch2{a,b,c}` and `bn...`) as a `ResNet` state dict:
    HWIO kernels to OIHW, raw BN statistics and conv biases folded (Keras
    BN epsilon 1e-3). Build the model with `resnet_import_kwargs('keras')`."""

    def conv_and_affine(conv_name, bn_name):
        kernel = np.asarray(_keras_find(flat, conv_name, "kernel"), np.float32)
        try:
            cbias = _keras_find(flat, conv_name, "bias")
        except KeyError:
            cbias = None
        aff = fold_batchnorm(_keras_find(flat, bn_name, "gamma"), _keras_find(flat, bn_name, "beta"),
                             _keras_find(flat, bn_name, "moving_mean"),
                             _keras_find(flat, bn_name, "moving_variance"), eps=eps, conv_bias=cbias)
        return kernel.transpose(3, 2, 0, 1), aff

    stem = conv_and_affine("conv1", "bn_conv1")
    out = []
    for stage, nblocks in enumerate(blocks):
        for j in range(nblocks):
            p = f"{stage + 2}{chr(ord('a') + j)}_branch"
            convs = [conv_and_affine(f"res{p}2{c}", f"bn{p}2{c}") for c in "abc"]
            try:
                convs.append(conv_and_affine(f"res{p}1", f"bn{p}1"))
            except KeyError:
                pass  # identity shortcut
            out.append(convs)
    return _resnet_state(stem[0], stem[1], out)


def load_torch_state_dict(path) -> dict:
    """A torch checkpoint → flat name → np.ndarray (an optional
    'state_dict' wrapper is unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def torch_resnet_params(sd: Mapping[str, np.ndarray], blocks: Sequence[int] = (3, 4, 6, 3),
                        eps: float = 1e-5) -> dict:
    """torchvision ResNet names (`conv1`/`bn1`, `layer{s}.{j}.conv{1-3}/
    bn{1-3}/downsample.{0,1}`) as a `ResNet` state dict, BN statistics
    folded. Build the model with `resnet_import_kwargs('torch')`."""

    def affine_of(prefix):
        return fold_batchnorm(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"],
                              sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"], eps=eps)

    out = []
    for stage, nblocks in enumerate(blocks):
        for j in range(nblocks):
            p = f"layer{stage + 1}.{j}"
            convs = [(sd[f"{p}.conv{i}.weight"], affine_of(f"{p}.bn{i}")) for i in (1, 2, 3)]
            if f"{p}.downsample.0.weight" in sd:
                convs.append((sd[f"{p}.downsample.0.weight"], affine_of(f"{p}.downsample.1")))
            out.append(convs)
    return _resnet_state(sd["conv1.weight"], affine_of("bn1"), out)


# torchvision `vgg16().features` indices of the conv layers through relu4_3
_VGG16_TORCH_CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21))


def torch_vgg16_params(sd: Mapping[str, np.ndarray]) -> dict:
    """A torchvision `vgg16().state_dict()` as the state dict of
    `models.features.VGG16Features` (convs through relu4_3; later layers
    are dropped). Torch kernels are OIHW already."""
    out = {}
    for s, idxs in enumerate(_VGG16_TORCH_CONV_IDX):
        for c, i in enumerate(idxs):
            out[f"conv{s}_{c}.weight"] = _t(sd[f"features.{i}.weight"])
            out[f"conv{s}_{c}.bias"] = _t(sd[f"features.{i}.bias"])
    return out


_BODY = "ResNetFPN_0.ResNet_0."


def graft_backbone(maskrcnn_state: Mapping[str, torch.Tensor],
                   resnet_state: Mapping[str, torch.Tensor]) -> dict:
    """A `MaskRCNN` state dict whose ResNet body is `resnet_state` (an
    imported `ResNet` state dict); FPN, RPN and heads keep theirs. The
    MaskRCNN must have the matching backbone (`backbone_norm='affine'`, the
    source's `stride_1x1`, the checkpoint's `base_width`): any missing,
    extra or misshapen body entry raises ValueError."""
    body = {k[len(_BODY):]: v for k, v in maskrcnn_state.items() if k.startswith(_BODY)}
    cur = {k: tuple(v.shape) for k, v in body.items()}
    new = {k: tuple(np.shape(v)) for k, v in resnet_state.items()}
    if cur != new:
        raise ValueError("imported backbone does not match the model's ResNet: "
                         f"model {cur} vs checkpoint {new}")
    out = dict(maskrcnn_state)
    for k, v in resnet_state.items():
        ref = maskrcnn_state[_BODY + k]
        out[_BODY + k] = torch.as_tensor(np.asarray(v)).to(dtype=ref.dtype, device=ref.device)
    return out
