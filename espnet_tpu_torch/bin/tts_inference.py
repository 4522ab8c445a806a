"""Text2Speech, the port's TTS API, and the batch-synthesis CLI
(counterpart of espnet_tpu/bin/tts_inference.py), for end-to-end GAN TTS
(VITS): text -> waveform.

``Text2Speech(train_config, model_file)`` tokenizes a text, pads it to a
length bucket (8, x1.3), synthesizes up to ``out_len`` frames at
``noise_scale`` and ``speed``, and returns the wave cut at its frame
count times the hop. z_p's noise is ``noise`` when given, else the draw
of a torch.Generator seeded with NOISE_SEED for each call, so that a
text gives the same wave whenever it is synthesized. The mel-spectrogram TTS
path (FastSpeech2, Tacotron2) with its vocoder or Griffin-Lim is not
ported yet and raises (ROADMAP A.5).

    python -m espnet_tpu_torch.bin.tts_inference --output_dir exp/tts \
        --data_path_and_name_and_type data/valid/text,text,text \
        --train_config assets/synth_tts_vits/config.yaml \
        --model_file assets/synth_tts_vits \
        [--noise_scale 0.333] [--device cpu]

writes ``<output_dir>/wav/<key>.wav`` (16-bit) and ``wav.scp``. It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import numpy as np
import torch

from espnet_tpu_torch.data.batching import bucket_length
from espnet_tpu_torch.data.dataset import ESPnetDataset
from espnet_tpu_torch.data.fileio import SoundScpWriter
from espnet_tpu_torch.tasks.abs_task import parse_triples
from espnet_tpu_torch.tasks.gan_tts import GANTTSTask
from espnet_tpu_torch.utils.config import load_yaml, parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

NOISE_SEED = 0
MEL_TTS = ("the mel-spectrogram TTS path with a vocoder or Griffin-Lim is "
           "not ported yet (ROADMAP A.5)")


class Text2Speech:
    def __init__(self, train_config=None, model_file=None,
                 vocoder_config=None, vocoder_file=None, speed: float = 1.0,
                 noise_scale: float = 0.667, device=None):
        cfg = load_yaml(train_config)
        if ("discriminator_conf" not in cfg or "feats_extract_conf" in cfg
                or vocoder_file is not None or vocoder_config is not None):
            raise NotImplementedError(MEL_TTS)
        self.device = resolve_device(device)
        self.model, self.cfg = GANTTSTask.build_model_from_file(
            train_config, model_file, self.device)
        self.preprocess = GANTTSTask.build_preprocess_fn(self.cfg,
                                                         train=False)
        self.speed, self.noise_scale = speed, noise_scale
        self.fs = self.cfg["fs"]
        self.hop_length = self.cfg["hop_length"]
        self.n_fft = self.cfg["n_fft"]

    def __call__(self, text, out_len: int = 512, noise=None):
        """text: str or token ids -> {"wav": (frames * hop,) float32,
        "feat_gen": None}. ``noise``: (1, out_len, z) draws for z_p."""
        if isinstance(text, str):
            ids = self.preprocess("<inference>", {
                "text": text,
                "speech": np.zeros(self.n_fft, np.float32)})["text"]
        else:
            ids = np.asarray(text, np.int64)
        L = len(ids)
        Lb = bucket_length(max(L, 1), base=8, growth=1.3)
        ids_in = torch.zeros(1, Lb, dtype=torch.int64, device=self.device)
        ids_in[0, :L] = torch.as_tensor(ids, dtype=torch.int64)
        lens = torch.tensor([L], device=self.device)
        generator = None
        if noise is None:
            generator = torch.Generator(self.device).manual_seed(NOISE_SEED)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32,
                                    device=self.device)
        wav, olens = self.model.decode(
            ids_in, lens, noise=noise, generator=generator,
            noise_scale=self.noise_scale, max_frames=out_len,
            speed=self.speed)
        T = max(int(olens[0]), 1)
        return {"wav": wav[0, :T * self.hop_length].cpu().numpy(),
                "feat_gen": None}

    @staticmethod
    def from_pretrained(model_tag=None, **kwargs):
        """From a packed model dir: its config.yaml and weights."""
        if model_tag is not None:
            d = Path(model_tag)
            kwargs.setdefault("train_config", d / "config.yaml")
            kwargs.setdefault("model_file", d)
        return Text2Speech(**kwargs)


def inference(output_dir, data_path_and_name_and_type, train_config,
              model_file, vocoder_config=None, vocoder_file=None, **kw):
    """Synthesize every text of the data triples, in key order, into
    ``output_dir``/wav and wav.scp; ``kw`` go to Text2Speech."""
    t2s = Text2Speech(train_config=train_config, model_file=model_file,
                      vocoder_config=vocoder_config,
                      vocoder_file=vocoder_file, **kw)
    ds = ESPnetDataset(parse_triples(data_path_and_name_and_type))
    out = Path(output_dir)
    with SoundScpWriter(out / "wav", out / "wav.scp") as w:
        for k in ds.keys():
            w[k] = (t2s.fs, t2s(ds[k][1]["text"])["wav"])
    logger.info("synthesized %d utterances -> %s", len(ds), out)


def main(argv=None):
    inference(**parse_cli_overrides(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
