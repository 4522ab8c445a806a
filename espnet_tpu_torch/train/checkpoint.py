"""Checkpoints (counterpart of espnet_tpu/train/checkpoint.py).

A checkpoint is a directory. ``params.pkl`` holds the parameters as the
JAX package's ``params.pkl`` does: a pickled nested dict of numpy arrays
under ``{"params": ...}`` in the flax tree's naming and layouts, so
``espnet_tpu.train.checkpoint.load_checkpoint`` reads a checkpoint that
the port trained. ``meta.json`` holds the epoch and the reporter.

The optimizer state is the port's own, ``opt_state.pt`` (torch.save of
the Adam moments and step count): the JAX package's ``opt_state.pkl``
pickles optax state objects, which only optax can unpickle, so neither
package reads the other's optimizer state.

``load_checkpoint`` also reads the committed assets' ``params_f16.npz``.
Files are written to a temporary name and renamed, so a run killed while
saving never leaves a truncated file where resume expects a whole one.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from espnet_tpu_torch import convert


def _atomic_write(path: Path, write):
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    tmp.replace(path)


def save_checkpoint(path, model: torch.nn.Module, optimizer=None,
                    meta: Optional[dict] = None,
                    params: Optional[Dict[str, np.ndarray]] = None):
    """Write ``model``'s parameters (or the flat flax dict ``params``),
    and the optimizer state and meta when given."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = convert.state_dict_to_flax(model) if params is None else params

    def dump(tmp):
        with open(tmp, "wb") as f:
            pickle.dump(convert.nest(flat), f)

    _atomic_write(path / "params.pkl", dump)
    if optimizer is not None:
        _atomic_write(path / "opt_state.pt",
                      lambda tmp: torch.save(optimizer.state_dict(), tmp))
    if meta is not None:
        _atomic_write(path / "meta.json",
                      lambda tmp: tmp.write_text(json.dumps(meta)))


def load_checkpoint(path, with_opt: bool = False, map_location="cpu"):
    """-> (flat flax params {"params/...": array}, optimizer state or
    None, meta). ``path`` is a checkpoint directory, a directory holding
    ``params_f16.npz``, or an npz file."""
    path = Path(path)
    if path.suffix == ".npz" or (path / "params_f16.npz").exists():
        flat = convert.read_npz(path if path.suffix == ".npz"
                                else path / "params_f16.npz")
    else:
        with open(path / "params.pkl", "rb") as f:
            flat = convert.flatten(pickle.load(f))
    opt_state = None
    if with_opt and (path / "opt_state.pt").exists():
        opt_state = torch.load(path / "opt_state.pt",
                               map_location=map_location, weights_only=True)
    meta = {}
    if path.is_dir() and (path / "meta.json").exists():
        meta = json.loads((path / "meta.json").read_text())
    return flat, opt_state, meta


def average_checkpoints(paths: List, out_path=None) -> Dict[str, np.ndarray]:
    """Uniform average of the parameters of several checkpoints."""
    acc = None
    for p in paths:
        flat, _, _ = load_checkpoint(p)
        if acc is None:
            acc = {k: np.asarray(v, np.float64) for k, v in flat.items()}
        else:
            for k, v in flat.items():
                acc[k] += v
    avg = {k: (v / len(paths)).astype(np.float32) for k, v in acc.items()}
    if out_path is not None:
        out = Path(out_path)
        out.mkdir(parents=True, exist_ok=True)
        save_checkpoint(out, None, params=avg,
                        meta={"averaged_from": [str(p) for p in paths]})
    return avg
