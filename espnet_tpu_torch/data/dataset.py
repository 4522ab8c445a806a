"""Utterance-keyed dataset (counterpart of espnet_tpu/data/dataset.py):
(path, name, type) triples -> self[uid] = (uid, {name: value}), through
the preprocessor (given the epoch, which the iterator sets, where it
``takes_epoch``); floats come out float32 and ints int32. The types read
are ``sound`` (wav.scp), ``text`` and ``npy`` (an scp of .npy arrays:
diarization labels, codec codes); the JAX package's others raise."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from espnet_tpu_torch.data.fileio import (NpyScpReader, SoundScpReader,
                                          read_2columns_text)


class _SoundLoader:
    def __init__(self, path):
        self.reader = SoundScpReader(path)

    def __getitem__(self, key):
        _, arr = self.reader[key]
        return arr[:, 0] if arr.ndim == 2 and arr.shape[1] == 1 else arr

    def keys(self):
        return self.reader.keys()


class _DictLoader:
    def __init__(self, data: dict):
        self.data = data

    def __getitem__(self, key):
        return self.data[key]

    def keys(self):
        return self.data.keys()


DATA_TYPES: Dict[str, Callable] = {
    "sound": _SoundLoader,
    "text": lambda p: _DictLoader(read_2columns_text(p)),
    "npy": NpyScpReader,
}


def build_loader(path: str, typ: str):
    """One loader of ``DATA_TYPES`` (the SpeechLM JSON's data entries)."""
    if typ not in DATA_TYPES:
        raise NotImplementedError(
            f"data type {typ!r}: the port reads {list(DATA_TYPES)}")
    return DATA_TYPES[typ](path)


class ESPnetDataset:
    def __init__(self, path_name_type_list: Sequence[Tuple[str, str, str]],
                 preprocess: Optional[Callable[[str, dict], dict]] = None):
        if len(path_name_type_list) == 0:
            raise ValueError("path_name_type_list must not be empty")
        self.loaders = {}
        for path, name, typ in path_name_type_list:
            if name in self.loaders:
                raise RuntimeError(f"duplicate data name {name!r}")
            self.loaders[name] = build_loader(path, typ)
        self.preprocess = preprocess
        self.epoch = 0

    def names(self):
        return list(self.loaders)

    def keys(self):
        return list(next(iter(self.loaders.values())).keys())

    def __len__(self):
        return len(self.keys())

    def __getitem__(self, uid: str) -> Tuple[str, Dict[str, np.ndarray]]:
        data = {name: loader[uid] for name, loader in self.loaders.items()}
        if getattr(self.preprocess, "takes_epoch", False):
            data = self.preprocess(uid, data, epoch=self.epoch)
        elif self.preprocess is not None:
            data = self.preprocess(uid, data)
        for name, v in data.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                data[name] = v.astype(np.float32)
            elif isinstance(v, np.ndarray) and v.dtype.kind == "i":
                data[name] = v.astype(np.int32)
        return uid, data
