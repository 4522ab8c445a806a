"""SeparateSpeech, the port's enhancement API, and the batch CLI
(counterpart of espnet_tpu/bin/enh_inference.py).

``SeparateSpeech(train_config, model_file, segment_size, hop_size, fs)``
separates a (S,) or (B, S) mixture into a list over speakers of (B, S)
float32 arrays. An input longer than ``segment_size`` seconds of ``fs``
goes through in overlapping segments: each is separated, its speakers
are put in the order that best matches the previous segment's over their
overlap, and the segments are added back under a Hann window and divided
by the window's sum, as in the JAX package.

``inference`` separates the ``speech_mix`` of a data dir one utterance at
a time and writes ``<output_dir>/spk{k}.scp`` with 16-bit wavs under
``<output_dir>/spk{k}/``:

    python -m espnet_tpu_torch.bin.enh_inference --output_dir exp/enh \\
        --data_path_and_name_and_type data/test/wav.scp,speech_mix,sound \\
        --train_config exp/enh/config.yaml --model_file exp/enh/checkpoint \\
        [--fs 16000] [--segment_size 2.0] [--device cpu]

It separates on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from espnet_tpu_torch.data.dataset import ESPnetDataset
from espnet_tpu_torch.data.fileio import SoundScpWriter
from espnet_tpu_torch.tasks.abs_task import parse_triples
from espnet_tpu_torch.tasks.enh import EnhancementTask
from espnet_tpu_torch.utils.config import parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class SeparateSpeech:
    def __init__(self, train_config=None, model_file=None,
                 segment_size: Optional[float] = None,
                 hop_size: Optional[float] = None,
                 normalize_segment_scale: bool = False,
                 normalize_output_wav: bool = False,
                 fs: int = 8000, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = EnhancementTask.build_model_from_file(
            train_config, model_file, self.device)
        self.segment_size = segment_size
        self.hop_size = hop_size or (segment_size / 2 if segment_size
                                     else None)
        self.normalize_segment_scale = normalize_segment_scale
        self.normalize_output_wav = normalize_output_wav
        self.fs = fs
        self.num_spk = self.model.num_spk

    @torch.no_grad()
    def _enhance(self, mix: np.ndarray, lengths) -> List[np.ndarray]:
        ests, _, _ = self.model.forward_enhance(
            torch.as_tensor(mix, dtype=torch.float32, device=self.device),
            torch.as_tensor(lengths, dtype=torch.int64, device=self.device))
        return [e.cpu().numpy() for e in ests]

    def __call__(self, speech_mix: np.ndarray, fs: Optional[int] = None
                 ) -> List[np.ndarray]:
        """(S,) or (B, S) mixture -> list over speakers of (B, S)."""
        speech_mix = np.asarray(speech_mix, np.float32)
        if speech_mix.ndim == 1:
            speech_mix = speech_mix[None]
        B, S = speech_mix.shape
        if self.segment_size is None or \
                S <= int(self.segment_size * self.fs):
            ests = self._enhance(speech_mix, np.full((B,), S))
        else:
            ests = self._segmented(speech_mix)
        if self.normalize_output_wav:
            ests = [e / max(np.abs(e).max(), 1e-9) * 0.9 for e in ests]
        return ests

    def _segmented(self, speech_mix: np.ndarray) -> List[np.ndarray]:
        B, S = speech_mix.shape
        seg = int(self.segment_size * self.fs)
        hop = int(self.hop_size * self.fs)
        out = [np.zeros((B, S), np.float64) for _ in range(self.num_spk)]
        norm = np.zeros((S,), np.float64)
        win = np.hanning(seg + 2)[1:-1] + 1e-6
        starts = list(range(0, max(S - seg, 0) + 1, hop))
        if starts[-1] + seg < S:
            starts.append(S - seg)
        prev_ests = None
        for st in starts:
            chunk = speech_mix[:, st:st + seg]
            if chunk.shape[1] < seg:
                chunk = np.pad(chunk, ((0, 0), (0, seg - chunk.shape[1])))
            ests = self._enhance(chunk, np.full((B,), seg))
            if self.normalize_segment_scale:
                ests = [e / max(np.abs(e).max(), 1e-9)
                        * np.abs(chunk).max() for e in ests]
            # the speaker order that best matches the previous segment
            # over the overlap (the whole batch's sum, as the JAX
            # package takes it)
            if prev_ests is not None and self.num_spk == 2:
                ov = min(seg - hop, S - st)
                a = np.sum(prev_ests[0][:, st:st + ov] * ests[0][:, :ov])
                b = np.sum(prev_ests[0][:, st:st + ov] * ests[1][:, :ov])
                if b > a:
                    ests = [ests[1], ests[0]]
            n = min(seg, S - st)
            for k in range(self.num_spk):
                out[k][:, st:st + n] += ests[k][:, :n] * win[:n]
            norm[st:st + n] += win[:n]
            prev_ests = [np.zeros((B, S)) for _ in range(self.num_spk)]
            for k in range(self.num_spk):
                prev_ests[k][:, st:st + n] = ests[k][:, :n]
        return [(o / np.maximum(norm, 1e-10)[None, :]).astype(np.float32)
                for o in out]

    @staticmethod
    def from_pretrained(model_tag=None, **kwargs):
        """A model dir: its config.yaml, and its ``model`` checkpoint or,
        as the committed assets hold them, the weights in the dir
        itself."""
        if model_tag is not None:
            d = Path(model_tag)
            kwargs.setdefault("train_config", d / "config.yaml")
            kwargs.setdefault("model_file", d / "model" if (d / "model")
                              .exists() else d)
        return SeparateSpeech(**kwargs)


def inference(output_dir, data_path_and_name_and_type, train_config,
              model_file, fs: int = 8000, device=None, **kw):
    """Separate every ``speech_mix`` of the data triples into
    ``<output_dir>/spk{k}.scp``; ``kw`` go to SeparateSpeech."""
    sep = SeparateSpeech(train_config=train_config, model_file=model_file,
                         fs=fs, device=device, **kw)
    ds = ESPnetDataset(parse_triples(data_path_and_name_and_type))
    out = Path(output_dir)
    writers = [SoundScpWriter(out / f"spk{k + 1}", out / f"spk{k + 1}.scp")
               for k in range(sep.num_spk)]
    for key in ds.keys():
        _, data = ds[key]
        ests = sep(data["speech_mix"])
        for k, w in enumerate(writers):
            w[key] = (fs, ests[k][0])
    for w in writers:
        w.close()
    logger.info("separated %d utterances -> %s", len(ds), out)


def main(argv=None):
    inference(**parse_cli_overrides(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
