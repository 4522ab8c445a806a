"""The GAN TTS tasks (counterpart of espnet_tpu/tasks/gan_tts.py):
``GANTTSTask`` (VITS: training through AbsGANTask, ``build_model`` with
its discriminator, ``build_model_from_file`` that loads the generator
part of a packed asset strictly, the preprocessor: char tokens, space as
``<space>``, and the linear spectrogram the posterior encoder reads) and
``GANVocoderTask`` (the HiFi-GAN vocoder: training through AbsGANTask on
random fixed-size wave crops). JETS raises: it waits (ROADMAP A.5).

The models are built in fp32 with deterministic cuDNN
(tasks/asr.py:fp32_and_deterministic): the couplings' inverse must undo
their forward, which cuDNN's default TF32 would not, and training must
repeat itself bit for bit.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict

import numpy as np

from espnet_tpu_torch import convert
from espnet_tpu_torch.data.preprocessor import CommonPreprocessor
from espnet_tpu_torch.models.tts.gan_vocoder import HiFiGANVocoderGAN
from espnet_tpu_torch.models.tts.vits_gan import VITSGan
from espnet_tpu_torch.tasks.abs_task import AbsGANTask, load_packed_config
from espnet_tpu_torch.tasks.asr import fp32_and_deterministic, read_token_list
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.device import resolve_device


def crop_rng(seed: int, epoch: int, uid: str) -> np.random.RandomState:
    """The random crop's generator for one utterance in one epoch: a run
    resumed at an epoch crops as an uninterrupted one does (the JAX
    package draws every crop from one RandomState(seed) stream, which a
    resumed run restarts)."""
    return np.random.RandomState([seed, epoch, zlib.crc32(uid.encode())])


def _np_linear_spec(wav: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Linear magnitude spectrogram on the host, Hann window, no padding:
    (S,) -> (1 + (S - n_fft) // hop, n_fft // 2 + 1)."""
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n = 1 + (max(len(wav) - n_fft, 0)) // hop
    frames = np.stack([wav[i * hop:i * hop + n_fft] for i in range(n)])
    return np.abs(np.fft.rfft(frames * win[None], axis=1)).astype(
        np.float32)


class GANTTSTask(AbsGANTask):
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
            fs=cfg["fs"], n_fft=cfg["n_fft"], hop_length=cfg["hop_length"],
            n_mels=cfg["n_mels"], tts=cfg.get("tts", "vits"),
            vits_conf=dict(cfg.get("tts_conf") or {}),
            discriminator_conf=dict(cfg.get("discriminator_conf") or {}))

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
        """(uid, {"text": str, "speech": wave}, epoch) -> text ids, the wave
        (cropped to max_wav_length when set: at random in training
        (``crop_rng``), from its start otherwise; padded to n_fft) and its
        linear spectrogram."""
        if cfg.get("g2p") is not None:
            raise NotImplementedError("g2p is not ported")
        tok = CommonPreprocessor(
            token_type=cfg.get("token_type", "char"),
            token_list=read_token_list(cfg["token_list"]),
            bpemodel=cfg.get("bpemodel"), text_cleaner=cfg.get("cleaner"))
        n_fft, hop = int(cfg["n_fft"]), int(cfg["hop_length"])
        max_len = int(cfg.get("max_wav_length") or 0)
        seed = cfg.get("seed", 0)

        def fn(uid, data, epoch=0):
            out = tok(uid, data)
            w = np.asarray(out["speech"], np.float32)
            if max_len and len(w) > max_len:
                s = (crop_rng(seed, epoch, uid).randint(
                    0, len(w) - max_len + 1) if train else 0)
                w = w[s:s + max_len]
            if len(w) < n_fft:
                w = np.pad(w, (0, n_fft - len(w)))
            return {"text": out["text"], "speech": w,
                    "spec": _np_linear_spec(w, n_fft, hop)}

        fn.takes_epoch = True
        return fn

    @classmethod
    def example_batch(cls, cfg: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """A batch of the model's shapes: two texts, their spectrograms
        (segment_frames + 4 frames, at least 36) and waves."""
        n_fft, hop = int(cfg["n_fft"]), int(cfg["hop_length"])
        seg = int(dict(cfg.get("tts_conf") or {}).get("segment_frames", 32))
        T = max(seg + 4, 36)
        return {"text": np.ones((2, 8), np.int32),
                "text_lengths": np.asarray([8, 6], np.int32),
                "spec": np.zeros((2, T, n_fft // 2 + 1), np.float32),
                "spec_lengths": np.asarray([T, T - 2], np.int32),
                "speech": np.zeros((2, (T - 1) * hop + n_fft), np.float32)}


class GANVocoderTask(AbsGANTask):
    """HiFi-GAN vocoder training. The preprocessor crops ``segment_size``
    samples of each wave (zero-padded when shorter): at random in
    training (``crop_rng``: per utterance and epoch), centred in
    validation. With ``feats`` (predicted
    log-mels, a teacher-forced fine-tune) the wave is cut to whole frames
    and the crop falls on frame boundaries, the log-mel edge-padded to
    segment_size / hop frames."""

    name = "gan_vocoder"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {"fs": 22050, "n_fft": 1024, "hop_length": 256, "n_mels": 80,
                "generator": "hifigan", "generator_conf": {},
                "discriminator_conf": {}, "segment_size": 8192,
                "batch_type": "unsorted", "use_preprocessor": True}

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> HiFiGANVocoderGAN:
        fp32_and_deterministic()
        return HiFiGANVocoderGAN(
            fs=cfg["fs"], n_fft=cfg["n_fft"], hop_length=cfg["hop_length"],
            n_mels=cfg["n_mels"], generator=cfg.get("generator", "hifigan"),
            generator_conf=dict(cfg.get("generator_conf") or {}),
            discriminator_conf=dict(cfg.get("discriminator_conf") or {}))

    @classmethod
    def build_preprocess_fn(cls, cfg: Dict[str, Any], train: bool):
        seg, hop = int(cfg["segment_size"]), int(cfg["hop_length"])
        seed = cfg.get("seed", 0)

        def fn(uid, data, epoch=0):
            w = np.asarray(data["speech"], np.float32)
            feats = data.get("feats")
            if feats is not None:
                feats = np.asarray(feats, np.float32)
                w = w[:min(len(w) // hop, len(feats)) * hop]
                seg_f = seg // hop
                if len(w) < seg:
                    w = np.pad(w, (0, seg - len(w)))
                    feats = np.pad(feats, ((0, seg_f - len(feats)), (0, 0)),
                                   mode="edge" if len(feats) else
                                   "constant")
                n_f = len(w) // hop
                s_f = (crop_rng(seed, epoch, uid).randint(0, n_f - seg_f + 1)
                       if train else (n_f - seg_f) // 2)
                return {"speech": w[s_f * hop:s_f * hop + seg],
                        "feats": feats[s_f:s_f + seg_f]}
            if len(w) < seg:
                w = np.pad(w, (0, seg - len(w)))
            s = (crop_rng(seed, epoch, uid).randint(0, len(w) - seg + 1)
                 if train else (len(w) - seg) // 2)
            return {"speech": w[s:s + seg]}

        fn.takes_epoch = True
        return fn

    @classmethod
    def example_batch(cls, cfg: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """One segment of wave, and its log-mel where the training data
        name ``feats``."""
        from espnet_tpu_torch.tasks.abs_task import parse_triples
        b = {"speech": np.zeros((1, int(cfg["segment_size"])), np.float32)}
        triples = cfg.get("train_data_path_and_name_and_type") or []
        if any(t[1] == "feats" for t in parse_triples(triples)):
            b["feats"] = np.zeros((1, int(cfg["segment_size"])
                                   // int(cfg["hop_length"]),
                                   int(cfg["n_mels"])), np.float32)
        return b
