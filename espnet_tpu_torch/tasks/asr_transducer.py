"""Transducer ASR task (counterpart of
espnet_tpu/tasks/asr_transducer.py:ASRTransducerTask), on the training
spine of ``tasks/abs_task.py``.

What the transducer asset's config names is built: the default frontend,
SpecAug, GlobalMVN (from ``stats_file``), a streaming conformer or
conformer encoder, an rnn or stateless prediction network, the joint
network and auxiliary CTC. Any other choice raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict

from espnet_tpu_torch.models.asr import ENCODER_CLASSES
from espnet_tpu_torch.models.transducer import (DECODER_CLASSES,
                                                TransducerModel)
from espnet_tpu_torch.tasks.asr import (ASRTask, _require, build_frontend,
                                        fp32_and_deterministic,
                                        read_token_list)


def build_model(cfg: Dict[str, Any]) -> TransducerModel:
    fp32_and_deterministic()
    frontend, normalize, specaug_conf = build_frontend(cfg)
    encoder = _require(cfg, "encoder", set(ENCODER_CLASSES), "conformer")
    decoder = _require(cfg, "decoder", set(DECODER_CLASSES), "rnn")
    token_list = read_token_list(cfg["token_list"])
    mc = dict(cfg.get("model_conf") or {})
    return TransducerModel(
        vocab_size=len(token_list), token_list=token_list,
        frontend=frontend, normalize=normalize, encoder=encoder,
        encoder_conf=dict(cfg.get("encoder_conf") or {}), decoder=decoder,
        decoder_conf=dict(cfg.get("decoder_conf") or {}),
        joint_conf=dict(cfg.get("joint_conf") or {}),
        specaug_conf=specaug_conf,
        aux_ctc_weight=mc.get("aux_ctc_weight", 0.0))


class ASRTransducerTask(ASRTask):
    """The ASR task's data path and preprocessor, with the transducer's
    defaults and model."""

    name = "asr_transducer"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "token_list": None,
            "token_type": "char",
            "bpemodel": None,
            "non_linguistic_symbols": [],
            "cleaner": None,
            "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
            "specaug": None,
            "specaug_conf": {},
            "normalize": "utterance_mvn",
            "stats_file": None,
            "encoder": "conformer",
            "encoder_conf": {},
            "decoder": "rnn",
            "decoder_conf": {},
            "joint_conf": {},
            "model_conf": {"aux_ctc_weight": 0.0},
        }

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> TransducerModel:
        return build_model(cfg)
