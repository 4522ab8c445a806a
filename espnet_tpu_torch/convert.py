"""Carry flax parameters into the port's modules, and back.

Reads the npz format of espnet_tpu/train/checkpoint.py (keys are the
parameter-tree path joined by "/", f16 stored and read back as f32) with
numpy only. The layout of each parameter is decided by the torch module
that holds it, not by the flax array's shape (a pointwise kernel
(1, in, out) and a transposed convolution's (K, in, out) look alike):

- Linear weight (out, in)              <- Dense kernel (in, out)
- Pointwise weight (out, in)           <- Conv(out, (1,)) kernel (1, in, out)
- Conv1d, DepthwiseConv1d weight
  (out, in / groups, K)                <- Conv kernel (K, in / groups, out)
- ConvTranspose1d weight (in, out, K)  <- ConvTranspose kernel (K, in, out),
  reversed in K (flax runs it unflipped over the dilated input)
- Conv2d weight (O, C, kt, kf)         <- 2-D conv kernel (kt, kf, C, O)
- LayerNorm ``weight``                 <- ``scale``
- Embedding ``weight`` (V, D)          <- Embed ``embedding``
- every other parameter (biases, ``pos_bias_u``, PReLU's 0-d
  ``negative_slope``)                  <- the array of the same name as it is

Module paths map one to one, except that flax's ``layerN`` is torch's
``layers.N``. Unused or missing keys raise. A checkpoint of several
parts (a GAN's ``generator/params/...`` and ``discriminator/params/...``)
loads one part by ``subtree``: that part's keys strictly, and a log line
that names the parts left out and their array counts. A model whose
``flax_parts`` names such parts (the GAN containers) is read and written
whole in that layout, each part strictly, as the JAX container's tree
holds it.
``state_dict_to_flax`` is the inverse: a model's parameters as the flat
flax dict, for checkpoints that the JAX package reads. ``compose`` roots
several flat dicts under submodules, so that one model takes the weights
of several assets.
"""

from __future__ import annotations

import logging
import re
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.nn.convolution import DepthwiseConv1d, Pointwise

logger = logging.getLogger(__name__)


def read_npz(path) -> Dict[str, np.ndarray]:
    """{"params/a/b/kernel": array} with f16 cast to f32."""
    with np.load(path) as z:
        return {k: (z[k].astype(np.float32) if z[k].dtype == np.float16
                    else z[k]) for k in z.files}


def _same(v):
    return v


def _t(v):
    return v.T


def _rev3(v):
    return v.transpose(2, 1, 0)


# (module types, flax leaf, flax -> torch, torch -> flax) of ``weight``;
# the first match decides (Pointwise before Linear)
_WEIGHT_LAYOUTS = (
    ((nn.LayerNorm,), "scale", _same, _same),
    ((nn.Embedding,), "embedding", _same, _same),
    ((Pointwise,), "kernel", lambda v: v[0].T, lambda v: v.T[None]),
    ((nn.Linear,), "kernel", _t, _t),
    ((nn.Conv1d, DepthwiseConv1d), "kernel", _rev3, _rev3),
    ((nn.ConvTranspose1d,), "kernel", lambda v: v[::-1].transpose(1, 2, 0),
     lambda v: v.transpose(2, 0, 1)[::-1]),
    ((nn.Conv2d,), "kernel", lambda v: v.transpose(3, 2, 0, 1),
     lambda v: v.transpose(2, 3, 1, 0)),
)


def _layout(module: nn.Module, name: str) -> Tuple[str, Callable, Callable]:
    """-> (flax leaf name, flax -> torch, torch -> flax) of one parameter."""
    if name != "weight":
        return name, _same, _same
    for types, leaf, to_torch, to_flax in _WEIGHT_LAYOUTS:
        if isinstance(module, types):
            return leaf, to_torch, to_flax
    raise ValueError(f"{type(module).__name__}.weight: no flax layout")


def _params(model: nn.Module) -> Iterator[Tuple[str, str, nn.Module, str]]:
    """(flax key, torch name, module, parameter name) of every parameter."""
    for mod_name, module in model.named_modules():
        path = re.sub(r"(^|\.)layers\.(\d+)", r"\1layer\2", mod_name)
        for name, _ in module.named_parameters(recurse=False):
            leaf = _layout(module, name)[0]
            key = "/".join(["params"] + ([path.replace(".", "/")] if path
                                         else []) + [leaf])
            yield key, f"{mod_name}.{name}" if mod_name else name, module, name


def take_subtree(flat: Dict[str, np.ndarray], root: str):
    """-> ({"params/...": array} of the keys under ``root/``, the other
    parts {top-level name: number of arrays})."""
    inner, left_out = {}, {}
    for key, value in flat.items():
        top, _, rest = key.partition("/")
        if top == root:
            inner[rest] = value
        else:
            left_out[top] = left_out.get(top, 0) + 1
    if not inner:
        raise KeyError(f"no parameters under {root!r}; the checkpoint has "
                       f"{sorted(left_out)}")
    return inner, left_out


def load_flax_params(model: torch.nn.Module, flat: Dict[str, np.ndarray],
                     subtree: Optional[str] = None):
    """Load a flat flax parameter dict, or its part under ``subtree``,
    into ``model``; raise on keys that are unused or missing, and on
    shapes that differ."""
    parts = getattr(model, "flax_parts", None)
    if parts and subtree is None:
        tops = {key.partition("/")[0] for key in flat}
        if tops != set(parts):
            raise KeyError(f"parts {sorted(tops)}, not {sorted(parts)}")
        for part in parts:
            load_flax_params(getattr(model, part),
                             take_subtree(flat, part)[0])
        return model
    if subtree is not None:
        flat, left_out = take_subtree(flat, subtree)
        logger.info("loaded %s; not loaded: %s", subtree, ", ".join(
            f"{k} ({n} arrays)" for k, n in sorted(left_out.items())))
    flat = {k if k.startswith("params/") else f"params/{k}": v
            for k, v in flat.items()}
    own = model.state_dict()
    entries = {key: (tname, module, name)
               for key, tname, module, name in _params(model)}
    missing = sorted(set(entries) - set(flat))
    unused = sorted(set(flat) - set(entries))
    if missing or unused:
        raise KeyError(f"parameter mismatch: missing {missing[:8]}, "
                       f"unused {unused[:8]}")
    state = {}
    for key, (tname, module, name) in entries.items():
        # np.array, not ascontiguousarray, which makes a 0-d array 1-d
        value = np.array(_layout(module, name)[1](np.asarray(flat[key])),
                         order="C")
        if own[tname].shape != value.shape:
            raise ValueError(f"{key} -> {tname}: shape "
                             f"{tuple(value.shape)} != "
                             f"{tuple(own[tname].shape)}")
        state[tname] = torch.from_numpy(value)
    # strict: a persistent buffer, which no flax tree holds, raises too
    model.load_state_dict(state)
    return model


def state_dict_to_flax(model: nn.Module,
                       grad: bool = False) -> Dict[str, np.ndarray]:
    """{"params/a/layer0/kernel": array}: the model's parameters (or,
    with ``grad``, their gradients, zeros where the loss does not reach
    a parameter) in the flax tree's naming and layouts
    (f32 numpy); a model with ``flax_parts`` as {"<part>/params/...":
    array}."""
    parts = getattr(model, "flax_parts", None)
    if parts:
        return {f"{part}/{key}": value for part in parts
                for key, value in state_dict_to_flax(getattr(model, part),
                                                     grad).items()}
    out = {}
    for key, _, module, name in _params(model):
        param = getattr(module, name)
        if grad and param.grad is None:   # unused: jax.grad's zeros
            value = np.zeros(tuple(param.shape), np.float32)
        else:
            value = (param.grad if grad else param).detach().cpu().numpy()
        out[key] = np.array(_layout(module, name)[2](value), order="C")
    return out


def compose(**parts: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """compose(enh=flat1, s2t=flat2) -> one flat dict with flat1's
    "params/x" at "params/enh/x" and flat2's at "params/s2t/x"."""
    out = {}
    for root, flat in parts.items():
        for key, value in flat.items():
            rest = key[len("params/"):] if key.startswith("params/") else key
            out[f"params/{root}/{rest}"] = value
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
