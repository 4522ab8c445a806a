"""End-to-end GAN TTS task (counterpart of espnet_tpu/tasks/gan_tts.py:
GANTTSTask) as far as synthesis needs it: ``build_model`` for
``tts: vits``, ``build_model_from_file`` that loads the generator part
of a packed asset strictly (the discriminator's arrays are named and
left out), and the preprocessor: char tokens (space as ``<space>``) and
the linear spectrogram the posterior encoder reads. VITS training, JETS
and the GAN vocoder task (``GANVocoderTask``) raise: they wait (ROADMAP
A.5).

The model is built in fp32 with deterministic cuDNN
(tasks/asr.py:fp32_and_deterministic): the couplings' inverse must undo
their forward, which cuDNN's default TF32 would not.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from espnet_tpu_torch import convert
from espnet_tpu_torch.data.preprocessor import CommonPreprocessor
from espnet_tpu_torch.models.tts.vits_gan import VITSGan
from espnet_tpu_torch.tasks.abs_task import AbsTask, load_packed_config
from espnet_tpu_torch.tasks.asr import fp32_and_deterministic, read_token_list
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.device import resolve_device


def _np_linear_spec(wav: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Linear magnitude spectrogram on the host, Hann window, no padding:
    (S,) -> (1 + (S - n_fft) // hop, n_fft // 2 + 1)."""
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n = 1 + (max(len(wav) - n_fft, 0)) // hop
    frames = np.stack([wav[i * hop:i * hop + n_fft] for i in range(n)])
    return np.abs(np.fft.rfft(frames * win[None], axis=1)).astype(
        np.float32)


class GANTTSTask(AbsTask):
    name = "gan_tts"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {"token_list": None, "token_type": "char", "fs": 22050,
                "n_fft": 1024, "hop_length": 256, "n_mels": 80,
                "tts": "vits", "tts_conf": {}, "discriminator_conf": {},
                "max_wav_length": 0, "use_preprocessor": True}

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> VITSGan:
        if cfg.get("tts") == "jets":
            raise NotImplementedError("tts: jets is not ported yet "
                                      "(ROADMAP A.5)")
        fp32_and_deterministic()
        return VITSGan(
            vocab_size=len(read_token_list(cfg["token_list"])),
            n_fft=cfg["n_fft"], hop_length=cfg["hop_length"],
            tts=cfg.get("tts", "vits"),
            vits_conf=dict(cfg.get("tts_conf") or {}))

    @classmethod
    def build_model_from_file(cls, config_file, model_file, device=None):
        """-> (the model with the generator part of ``model_file``, in eval
        mode on ``device`` (None: the card), and its config)."""
        device = resolve_device(device)
        cfg = load_packed_config(config_file)
        model = cls.build_model(cfg)
        convert.load_flax_params(model.generator,
                                 load_checkpoint(model_file)[0],
                                 subtree="generator")
        return model.to(device).eval(), cfg

    @classmethod
    def build_preprocess_fn(cls, cfg: Dict[str, Any], train: bool):
        """(uid, {"text": str, "speech": wave}) -> text ids, the wave
        (cropped to max_wav_length when set: at random in training, from
        its start otherwise; padded to n_fft) and its linear spectrogram."""
        if cfg.get("g2p") is not None:
            raise NotImplementedError("g2p is not ported")
        tok = CommonPreprocessor(
            token_type=cfg.get("token_type", "char"),
            token_list=read_token_list(cfg["token_list"]),
            bpemodel=cfg.get("bpemodel"), text_cleaner=cfg.get("cleaner"))
        n_fft, hop = int(cfg["n_fft"]), int(cfg["hop_length"])
        max_len = int(cfg.get("max_wav_length") or 0)
        crop_rng = np.random.RandomState(cfg.get("seed", 0))

        def fn(uid, data):
            out = tok(uid, data)
            w = np.asarray(out["speech"], np.float32)
            if max_len and len(w) > max_len:
                s = (crop_rng.randint(0, len(w) - max_len + 1) if train
                     else 0)
                w = w[s:s + max_len]
            if len(w) < n_fft:
                w = np.pad(w, (0, n_fft - len(w)))
            return {"text": out["text"], "speech": w,
                    "spec": _np_linear_spec(w, n_fft, hop)}

        return fn


class GANVocoderTask(AbsTask):
    """Not ported yet: ROADMAP A.5 (VITS training and the GAN vocoder)."""

    name = "gan_vocoder"

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]):
        raise NotImplementedError("the GAN vocoder task is not ported yet "
                                  "(ROADMAP A.5)")
