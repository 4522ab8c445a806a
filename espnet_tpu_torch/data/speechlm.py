"""SpeechLM data: the vocabulary, task templates, the delay layout and the
JSON datasets (a copy of espnet_tpu/data/speechlm.py, numpy only).

Every example is a (T, Q) array of global ids and a (T,) loss mask.
Stream 0 carries specials, task tags, text and codec stream 0; streams
q > 0 carry specials and codec stream q, with ``<filler>`` over text.
Audio regions take the delay layout (stream q shifted right by q). The
loss mask is 0 over [bos][tag][condition] and 1 over target and eos.
A dataset JSON names its task, its data entries (name, path, loader
type of ``data/dataset.py:DATA_TYPES``) and its sample ids.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Task templates (espnet2/speechlm/dataloader/task_conf.py:16-29 role)
# ---------------------------------------------------------------------------

#: task name -> (condition entries, target entries). Entries are data
#: names in the dataset JSON; `text*` entries are tokenized text,
#: `audio*` entries are codec-code arrays (T, Q) or raw token columns.
TASK_TEMPLATES: Dict[str, Dict[str, Sequence[str]]] = {
    "text_to_audio": {"condition": ("text1",), "target": ("audio1",)},
    "audio_to_text": {"condition": ("audio1",), "target": ("text1",)},
    "text_only": {"condition": (), "target": ("text1",)},
    "audio_continuation": {"condition": (), "target": ("audio1",)},
}


class SpeechLMVocabulary:
    """Packed per-stream id space (speechlm vocab/multimodal_io role).

    Stream 0:  [specials | task tags | text vocab | codec codebook]
    Stream q>0:[specials | task tags |            | codec codebook]

    All streams share the special ids (so pad/bos/eos compare equal in
    any stream) and the codec offset is the SAME in every stream, which
    keeps `encode_audio`/`decode_audio` a single vectorized add.
    """

    SPECIALS = ("<pad>", "<bos>", "<eos>", "<filler>")

    def __init__(self, text_vocab_size: int, codebook_size: int,
                 n_streams: int,
                 tasks: Sequence[str] = tuple(TASK_TEMPLATES)):
        self.n_streams = int(n_streams)
        self.codebook_size = int(codebook_size)
        self.text_vocab_size = int(text_vocab_size)
        self.task_tags = {t: len(self.SPECIALS) + i
                          for i, t in enumerate(tasks)}
        self.text_offset = len(self.SPECIALS) + len(self.task_tags)
        self.codec_offset = self.text_offset + self.text_vocab_size
        self.size0 = self.codec_offset + self.codebook_size

    # -- ids ---------------------------------------------------------------
    @property
    def pad(self) -> int:
        return self.SPECIALS.index("<pad>")

    @property
    def bos(self) -> int:
        return self.SPECIALS.index("<bos>")

    @property
    def eos(self) -> int:
        return self.SPECIALS.index("<eos>")

    @property
    def filler(self) -> int:
        return self.SPECIALS.index("<filler>")

    @property
    def vocab_sizes(self) -> Tuple[int, ...]:
        """Per-stream embedding/head sizes for models/speechlm.SpeechLM.
        All streams use the stream-0 size: ids never exceed it and a
        uniform size keeps the head stack stackable."""
        return tuple([self.size0] * self.n_streams)

    # -- encode ------------------------------------------------------------
    def encode_text(self, ids: np.ndarray) -> np.ndarray:
        """(Tt,) local text ids -> (Tt, Q): stream 0 ids, rest filler."""
        ids = np.asarray(ids, np.int32) + self.text_offset
        out = np.full((len(ids), self.n_streams), self.filler, np.int32)
        out[:, 0] = ids
        return out

    def encode_audio(self, codes: np.ndarray) -> np.ndarray:
        """(Ta, Q) local codec codes -> (Ta, Q) global ids."""
        codes = np.asarray(codes, np.int32)
        if codes.ndim == 1:
            codes = codes[:, None]
        if codes.shape[1] != self.n_streams:
            raise ValueError(
                f"audio entry has {codes.shape[1]} streams, vocabulary "
                f"expects {self.n_streams}")
        return codes + self.codec_offset

    def frame(self, special: int) -> np.ndarray:
        """(1, Q) frame holding one special/tag id in every stream."""
        return np.full((1, self.n_streams), special, np.int32)

    # -- decode ------------------------------------------------------------
    def decode_audio(self, tokens: np.ndarray) -> np.ndarray:
        """Global (T, Q) -> local codec codes, clipped into codebook."""
        return np.clip(np.asarray(tokens, np.int64) - self.codec_offset,
                       0, self.codebook_size - 1).astype(np.int32)

    def decode_text(self, tokens0: np.ndarray) -> List[int]:
        """Stream-0 global ids -> local text ids (non-text ids dropped)."""
        toks = np.asarray(tokens0, np.int64)
        keep = (toks >= self.text_offset) & (toks < self.codec_offset)
        return [int(t - self.text_offset) for t in toks[keep]]

    def is_audio(self, tokens0: np.ndarray) -> np.ndarray:
        toks = np.asarray(tokens0, np.int64)
        return toks >= self.codec_offset


def delay_codes(frames: np.ndarray, pad: int) -> np.ndarray:
    """MusicGen delay on a (T, Q) region: stream q shifted right by q,
    length grows to T + Q - 1; vacated slots take `pad`."""
    T, Q = frames.shape
    out = np.full((T + Q - 1, Q), pad, frames.dtype)
    for q in range(Q):
        out[q:q + T, q] = frames[:, q]
    return out


def undelay_codes(frames: np.ndarray) -> np.ndarray:
    """Inverse of delay_codes: (T + Q - 1, Q) -> (T, Q)."""
    Td, Q = frames.shape
    T = Td - Q + 1
    return np.stack([frames[q:q + T, q] for q in range(Q)], axis=-1)


def build_example(task: str, entries: Dict[str, np.ndarray],
                  vocab: SpeechLMVocabulary,
                  text_to_ids: Optional[Callable[[str], Sequence[int]]]
                  = None,
                  delay: bool = True) -> Dict[str, np.ndarray]:
    """Linearize one example:

        [bos][task tag][condition...][target...][eos]

    with loss_mask = 0 over bos/tag/condition, 1 over target+eos
    (the reference scores only the continuation region; speechlm
    lm/loss.py role). Audio target regions optionally get the delay
    layout. Returns {"tokens": (T, Q) int32, "loss_mask": (T,) f32}.
    """
    tpl = TASK_TEMPLATES[task]
    segs: List[np.ndarray] = [vocab.frame(vocab.bos),
                              vocab.frame(vocab.task_tags[task])]
    mask: List[np.ndarray] = [np.zeros(2, np.float32)]

    def render(name: str) -> np.ndarray:
        val = entries[name]
        if name.startswith("text"):
            if isinstance(val, (str, bytes)):
                if text_to_ids is None:
                    raise ValueError(
                        f"entry {name} is raw text but no text_to_ids "
                        f"tokenizer was given")
                val = np.asarray(list(text_to_ids(str(val))), np.int32)
            return vocab.encode_text(np.asarray(val, np.int32).reshape(-1))
        g = vocab.encode_audio(val)
        return delay_codes(g, vocab.filler) if delay else g

    for name in tpl["condition"]:
        seg = render(name)
        segs.append(seg)
        mask.append(np.zeros(len(seg), np.float32))
    for name in tpl["target"]:
        seg = render(name)
        segs.append(seg)
        mask.append(np.ones(len(seg), np.float32))
    segs.append(vocab.frame(vocab.eos))
    mask.append(np.ones(1, np.float32))
    return {"tokens": np.concatenate(segs, axis=0),
            "loss_mask": np.concatenate(mask)}


# ---------------------------------------------------------------------------
# JSON datasets (espnet2/speechlm/dataloader/dataset.py SingleDataset +
# bin/prepare_dataset_json.py contract)
# ---------------------------------------------------------------------------

def write_dataset_json(path, task: str,
                       data_entry: Sequence[Dict[str, str]],
                       samples: Sequence[str]) -> None:
    """Write a prepared dataset JSON (prepare_dataset_json.py output
    shape): {"task", "data_entry": [{name, path, type}], "samples"}."""
    tpl = TASK_TEMPLATES[task]
    have = {e["name"] for e in data_entry}
    need = set(tpl["condition"]) | set(tpl["target"])
    missing = need - have
    if missing:
        raise ValueError(f"task {task} requires entries {sorted(need)}; "
                         f"missing {sorted(missing)}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps({
        "task": task,
        "data_entry": list(data_entry),
        "samples": list(samples),
    }, indent=1), encoding="utf-8")


class SpeechLMJSONDataset:
    """One task's dataset from a prepared JSON (SingleDataset role).

    Readers reuse the framework loader registry (data/dataset.py
    DATA_TYPES): `npy` for codec codes, `text` for transcripts, `sound`
    for raw audio, etc. Yields the RAW entry dict; linearization into
    token streams happens in MultiTaskSpeechLMDataset so one example
    can serve several task renderings.
    """

    def __init__(self, json_file):
        spec = json.loads(Path(json_file).read_text(encoding="utf-8"))
        self.task: str = spec["task"]
        if self.task not in TASK_TEMPLATES:
            raise ValueError(f"unknown speechlm task {self.task!r}; "
                             f"known: {sorted(TASK_TEMPLATES)}")
        from espnet_tpu_torch.data.dataset import build_loader
        self.readers = {e["name"]: build_loader(e["path"], e["type"])
                        for e in spec["data_entry"]}
        self.samples: List[str] = list(spec["samples"])

    def keys(self) -> List[str]:
        return self.samples

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, uid: str) -> Dict[str, Any]:
        return {name: r[uid] for name, r in self.readers.items()}


class MultiTaskSpeechLMDataset:
    """Several task JSONs fused into one ESPnetDataset-compatible view
    (the --multi_task_dataset mode, abs_task.py:996-1003 +
    ESPnetMultiTaskDataset train/dataset.py:697 role).

    Keys are namespaced `task@uid` so identical utterance ids across
    tasks never collide. Examples are linearized lazily per access.
    """

    def __init__(self, json_files: Sequence[str],
                 vocab: SpeechLMVocabulary,
                 text_to_ids: Optional[Callable] = None,
                 delay: bool = True):
        self.datasets = [SpeechLMJSONDataset(f) for f in json_files]
        self.vocab = vocab
        self.text_to_ids = text_to_ids
        self.delay = delay
        self._keys: List[str] = []
        self._route: Dict[str, Tuple[int, str]] = {}
        for i, ds in enumerate(self.datasets):
            for uid in ds.keys():
                k = f"{ds.task}@{uid}" if len(self.datasets) > 1 else uid
                self._keys.append(k)
                self._route[k] = (i, uid)

    def names(self) -> Tuple[str, ...]:
        return ("tokens", "loss_mask")

    def keys(self) -> List[str]:
        return self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, uid: str):
        i, raw = self._route[uid]
        ds = self.datasets[i]
        ex = build_example(ds.task, ds[raw], self.vocab,
                           text_to_ids=self.text_to_ids, delay=self.delay)
        return uid, ex
