"""Enhancement tasks (counterpart of espnet_tpu/tasks/enh.py):
``EnhancementTask`` (separation, trained with PIT) and ``EnhS2TTask``
(joint enhancement + ASR), on the training spine of
``tasks/abs_task.py``; ``build_model_from_file`` is AbsTask's.

Both build their models in fp32 with deterministic cuDNN
(``tasks/asr.py:fp32_and_deterministic``): cuDNN's default TF32 would put
the TCN's pointwise and depthwise convolutions ~1e-3 off the CPU, and its
fastest weight-gradient algorithms add in an order that changes between
runs. The iSTFT's overlap-add is F.fold, which has no atomics.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

from espnet_tpu_torch import convert
from espnet_tpu_torch.models.enh.model import EnhancementModel
from espnet_tpu_torch.tasks.abs_task import AbsTask, load_packed_config
from espnet_tpu_torch.tasks.asr import (ASRTask, fp32_and_deterministic,
                                        read_token_list)
from espnet_tpu_torch.train.checkpoint import load_checkpoint


class EnhancementTask(AbsTask):
    name = "enh"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "num_spk": 2,
            "encoder": "stft",
            "encoder_conf": {"n_fft": 512, "hop_length": 128},
            "separator": "rnn",
            "separator_conf": {},
            "loss_type": "si_snr",
            "use_preprocessor": False,
        }

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> EnhancementModel:
        fp32_and_deterministic()
        ec = dict(cfg.get("encoder_conf") or {})
        return EnhancementModel(
            num_spk=cfg.get("num_spk", 2),
            encoder=cfg.get("encoder", "stft"),
            n_fft=ec.get("n_fft", 512),
            hop_length=ec.get("hop_length", 128),
            # the reference's ConvEncoder spells it "channel"
            conv_channels=ec.get("channels", ec.get("channel", 256)),
            conv_kernel=ec.get("kernel_size", 32),
            conv_stride=ec.get("stride", 16),
            separator=cfg.get("separator", "rnn"),
            separator_conf=dict(cfg.get("separator_conf") or {}),
            loss_type=cfg.get("loss_type", "si_snr"))

    @classmethod
    def example_batch(cls, cfg: Dict[str, Any]) -> Dict[str, np.ndarray]:
        b = {
            "speech_mix": np.zeros((1, 2048), np.float32),
            "speech_mix_lengths": np.asarray([2048], np.int32),
            "speech_ref1": np.zeros((1, 2048), np.float32),
        }
        if cfg.get("num_spk", 2) >= 2:
            b["speech_ref2"] = np.zeros((1, 2048), np.float32)
        return b


class EnhS2TTask(AbsTask):
    """Joint enhancement + ASR: ``enh_conf`` (EnhancementModel's fields)
    and ``asr_conf`` (the JAX package's ASRModel fields) make one model;
    the data are the mixture, its transcript and, for the enhancement
    loss, the clean reference speech_ref1."""

    name = "enh_s2t"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "token_list": None,
            "token_type": "char",
            "bpemodel": None,
            "non_linguistic_symbols": [],
            "cleaner": None,
            "enh_conf": {"num_spk": 1, "separator": "rnn"},
            "asr_conf": {},
            "enh_weight": 0.2,
        }

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]):
        from espnet_tpu_torch.models.enh_s2t import EnhS2TModel
        fp32_and_deterministic()
        token_list = read_token_list(cfg["token_list"])
        return EnhS2TModel(
            vocab_size=len(token_list), token_list=tuple(token_list),
            enh_conf=dict(cfg.get("enh_conf") or {}),
            asr_conf=dict(cfg.get("asr_conf") or {}),
            enh_weight=cfg.get("enh_weight", 0.2))

    @classmethod
    def build_preprocess_fn(cls, cfg: Dict[str, Any], train: bool):
        return ASRTask.build_preprocess_fn(cfg, train)

    @staticmethod
    def config_from_assets(enh_dir, asr_dir,
                           enh_weight: float = 0.2) -> Dict[str, Any]:
        """The joint model's config from an enhancement model dir and a
        hybrid ASR model dir (config.yaml each, laid out as the assets
        are): enh_conf as EnhancementTask builds the first, asr_conf as
        ASRTask builds the second, in the JAX package's ASRModel
        fields."""
        ec = load_packed_config(Path(enh_dir) / "config.yaml")
        ac = load_packed_config(Path(asr_dir) / "config.yaml")
        enc = dict(ec.get("encoder_conf") or {})
        mc = dict(ac.get("model_conf") or {})
        return {
            "token_list": ac["token_list"],
            "token_type": ac.get("token_type", "char"),
            "non_linguistic_symbols": ac.get("non_linguistic_symbols") or [],
            "enh_conf": {
                "num_spk": ec.get("num_spk", 2),
                "encoder": ec.get("encoder", "stft"),
                "n_fft": enc.get("n_fft", 512),
                "hop_length": enc.get("hop_length", 128),
                "separator": ec.get("separator", "rnn"),
                "separator_conf": dict(ec.get("separator_conf") or {}),
                "loss_type": ec.get("loss_type", "si_snr")},
            "asr_conf": {
                "frontend_conf": dict(ac.get("frontend_conf") or {}),
                "specaug_conf": (dict(ac.get("specaug_conf") or {})
                                 if ac.get("specaug") == "specaug"
                                 else None),
                "normalize": ac.get("normalize"),
                "stats_file": ac.get("stats_file"),
                "encoder": ac.get("encoder", "transformer"),
                "encoder_conf": dict(ac.get("encoder_conf") or {}),
                "decoder": ac.get("decoder", "transformer"),
                "decoder_conf": dict(ac.get("decoder_conf") or {}),
                "ctc_weight": mc.get("ctc_weight", 0.5),
                "lsm_weight": mc.get("lsm_weight", 0.0),
                "length_normalized_loss": mc.get("length_normalized_loss",
                                                 False)},
            "enh_weight": enh_weight,
        }

    @staticmethod
    def weights_from_assets(enh_dir, asr_dir) -> Dict[str, Any]:
        """The joint model's flat flax weights: the enhancement model's
        under params/enh, the ASR model's under params/s2t."""
        return convert.compose(enh=load_checkpoint(enh_dir)[0],
                               s2t=load_checkpoint(asr_dir)[0])

    @classmethod
    def example_batch(cls, cfg: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {
            "speech_mix": np.zeros((1, 2048), np.float32),
            "speech_mix_lengths": np.asarray([2048], np.int32),
            "text": np.zeros((1, 8), np.int32),
            "text_lengths": np.asarray([8], np.int32),
        }
