"""Kaldi-style file IO (counterpart of espnet_tpu/data/fileio.py): text
maps, number sequences, WAV read/write with the standard library and
numpy (PCM 8/16/32-bit and IEEE float), without soundfile, the wav.scp
writer of the separated speech, the npy scp reader and writer (label and
code arrays), and the nested text-map writer of the decode outputs."""

from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np


def read_2columns_text(path: Union[Path, str]) -> Dict[str, str]:
    """'key value...' per line -> {key: value}; duplicate keys raise."""
    d = {}
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            sps = line.rstrip("\n").split(maxsplit=1)
            if not sps:
                continue
            k, v = (sps[0], "") if len(sps) == 1 else sps
            if k in d:
                raise RuntimeError(f"duplicate key {k!r} at {path}:{ln}")
            d[k] = v
    return d


def load_num_sequence_text(path, loader_type: str = "text_int"):
    """'key 1 2 3' (or 'key 1,2,3' for csv_*) -> {key: array}."""
    dtype = np.int64 if "int" in loader_type else np.float32
    sep = "," if loader_type.startswith("csv") else None
    return {k: np.asarray(v.split(sep), dtype=dtype)
            for k, v in read_2columns_text(path).items()}


def read_wav(path: Union[Path, str]) -> Tuple[int, np.ndarray]:
    """-> (rate, float32 array in [-1, 1], shape (S,) or (S, C))."""
    path = str(path)
    fmt_code = n_ch = rate = bits = data_off = data_size = None
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(csize)
                fmt_code, n_ch, rate = struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
                f.seek(csize & 1, 1)
            elif cid == b"data":
                data_off, data_size = f.tell(), csize
                f.seek(csize + (csize & 1), 1)
            else:
                f.seek(csize + (csize & 1), 1)
    if fmt_code is None or data_off is None:
        raise ValueError(f"malformed wav: {path}")
    raw = np.fromfile(path, dtype=np.uint8, count=data_size, offset=data_off)
    if fmt_code == 1 and bits == 16:
        x = raw.view("<i2").astype(np.float32) / 32768.0
    elif fmt_code == 1 and bits == 32:
        x = raw.view("<i4").astype(np.float32) / 2147483648.0
    elif fmt_code == 1 and bits == 8:
        x = (raw.astype(np.float32) - 128.0) / 128.0
    elif fmt_code == 3 and bits == 32:
        x = raw.view("<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported wav format {fmt_code}, {bits} bits")
    return rate, x.reshape(-1, n_ch) if n_ch > 1 else x


def write_wav(path: Union[Path, str], rate: int, data: np.ndarray):
    """float in [-1, 1] (clipped) or int16 -> 16-bit PCM wav."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if data.dtype != np.int16:
        data = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


class SoundScpReader:
    """wav.scp: key -> (rate, float32 array), read when asked for."""

    def __init__(self, path):
        self.data = read_2columns_text(path)

    def __getitem__(self, key) -> Tuple[int, np.ndarray]:
        entry = self.data[key]
        if entry.endswith("|"):
            raise RuntimeError("piped wav.scp entries are not supported")
        return read_wav(entry)

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)


class SoundScpWriter:
    """Writes ``<outdir>/<key>.wav`` (16-bit) and a wav.scp line for each
    ``writer[key] = (rate, array)``."""

    def __init__(self, outdir, scpfile):
        self.dir = Path(outdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        Path(scpfile).parent.mkdir(parents=True, exist_ok=True)
        self.fscp = open(scpfile, "w", encoding="utf-8")

    def __setitem__(self, key: str, value: Tuple[int, np.ndarray]):
        rate, arr = value
        p = self.dir / f"{key}.wav"
        write_wav(p, rate, arr)
        self.fscp.write(f"{key} {p}\n")

    def close(self):
        self.fscp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class NpyScpReader:
    """key -> np.load(path) of a 'key path.npy' scp."""

    def __init__(self, path):
        self.data = read_2columns_text(path)

    def __getitem__(self, key):
        return np.load(self.data[key])

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)


class NpyScpWriter:
    """writer[key] = array saves outdir/key.npy and adds 'key path' to the
    scp."""

    def __init__(self, outdir, scpfile):
        self.dir = Path(outdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        Path(scpfile).parent.mkdir(parents=True, exist_ok=True)
        self.fscp = open(scpfile, "w", encoding="utf-8")

    def __setitem__(self, key: str, value: np.ndarray):
        p = self.dir / f"{key}.npy"
        np.save(p, value)
        self.fscp.write(f"{key} {p}\n")

    def close(self):
        self.fscp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class DatadirWriter:
    """Nested text-map writer: ``w["1best_recog"]["text"][key] = "hello"``
    writes the line "key hello" to ``<dir>/1best_recog/text``."""

    def __init__(self, p: Union[Path, str]):
        self.path = Path(p)
        self.children = {}
        self.fd = None

    def __getitem__(self, key) -> "DatadirWriter":
        if self.fd is not None:
            raise RuntimeError("already opened as a file")
        if key not in self.children:
            self.children[key] = DatadirWriter(self.path / key)
        return self.children[key]

    def __setitem__(self, key: str, value: str):
        if self.children:
            raise RuntimeError("already a directory")
        if self.fd is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.fd = open(self.path, "w", encoding="utf-8")
        self.fd.write(f"{key} {value}\n")

    def close(self):
        if self.fd is not None:
            self.fd.close()
        for c in self.children.values():
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
