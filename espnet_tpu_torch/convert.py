"""Carry flax parameters into the port's modules, and back.

Reads the npz format of espnet_tpu/train/checkpoint.py (keys are the
parameter-tree path joined by "/", f16 stored and read back as f32) with
numpy only, and maps flax layouts onto torch's:

- Dense kernel (in, out)            -> Linear weight (out, in)
- 2-D conv kernel (kt, kf, C, O)     -> Conv2d weight (O, C, kt, kf)
- DepthwiseConv1d kernel (K, 1, C)   -> grouped Conv1d weight (C, 1, K)
- LayerNorm ``scale``                -> ``weight``
- Embed ``embedding`` (V, D)         -> Embedding ``weight``
- ``pos_bias_u``, ``pos_bias_v``     -> parameters of the same (H, dk) shape

Module paths map one to one, except that flax's ``layerN`` is torch's
``layers.N``. Unused or missing keys raise. ``state_dict_to_flax`` is the
inverse: a model's parameters as the flat flax dict, for checkpoints that
the JAX package reads.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn


def read_npz(path) -> Dict[str, np.ndarray]:
    """{"params/a/b/kernel": array} with f16 cast to f32."""
    with np.load(path) as z:
        return {k: (z[k].astype(np.float32) if z[k].dtype == np.float16
                    else z[k]) for k in z.files}


def _torch_entry(path: str, value: np.ndarray):
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    mods = [re.sub(r"^layer(\d+)$", r"layers.\1", p) for p in parts[:-1]]
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 3 and value.shape[1] == 1:
            value = value.transpose(2, 1, 0)
        else:
            raise ValueError(f"{path}: unexpected kernel shape {value.shape}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), np.ascontiguousarray(value)


def flax_to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out = {}
    for path, value in flat.items():
        name, value = _torch_entry(path, value)
        out[name] = torch.from_numpy(value)
    return out


def load_flax_params(model: torch.nn.Module, flat: Dict[str, np.ndarray]):
    """Load a flat flax parameter dict into ``model``; raise on keys that
    are unused or missing, and on shapes that differ."""
    state = flax_to_state_dict(flat)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"parameter mismatch: missing {missing[:8]}, "
                       f"unused {unused[:8]}")
    for name, value in state.items():
        if own[name].shape != value.shape:
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(own[name].shape)}")
    model.load_state_dict(state)
    return model


def _flax_entry(module: nn.Module, name: str, value: np.ndarray):
    """Leaf name and layout of one torch parameter in the flax tree."""
    if name != "weight":
        return name, value
    if isinstance(module, nn.LayerNorm):
        return "scale", value
    if isinstance(module, nn.Embedding):
        return "embedding", value
    if value.ndim == 2:
        return "kernel", value.T
    if value.ndim == 4:
        return "kernel", value.transpose(2, 3, 1, 0)
    if value.ndim == 3 and value.shape[1] == 1:
        return "kernel", value.transpose(2, 1, 0)
    raise ValueError(f"{type(module).__name__}.weight: unexpected shape "
                     f"{value.shape}")


def state_dict_to_flax(model: nn.Module,
                       grad: bool = False) -> Dict[str, np.ndarray]:
    """{"params/a/layer0/kernel": array}: the model's parameters (or,
    with ``grad``, their gradients) in the flax tree's naming and layouts
    (f32 numpy)."""
    out = {}
    for mod_name, module in model.named_modules():
        path = re.sub(r"(^|\.)layers\.(\d+)", r"\1layer\2", mod_name)
        for name, param in module.named_parameters(recurse=False):
            value = param.grad if grad else param
            leaf, value = _flax_entry(module, name,
                                      value.detach().cpu().numpy())
            key = "/".join(["params"] + ([path.replace(".", "/")] if path
                                         else []) + [leaf])
            out[key] = np.ascontiguousarray(value)
    return out


def nest(flat: Dict[str, np.ndarray]) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of ``nest``."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out
