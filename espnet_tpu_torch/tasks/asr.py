"""ASR task: build the model from a config dict (counterpart of
espnet_tpu/tasks/asr.py:ASRTask and tasks/abs_task.py:build_model_from_file).

Only what the flagship config names is built: the default frontend,
SpecAug, GlobalMVN, a conformer (or streaming conformer) encoder and a
transformer decoder. Any other choice raises NotImplementedError. The
model comes out in training mode (dropout and SpecAug on);
``ASRTask.build_model_from_file`` (AbsTask's) puts it in eval mode for
decoding. ``ASRTask``
adds the task's defaults and its preprocessor to the training spine of
``tasks/abs_task.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import torch

from espnet_tpu_torch.data.preprocessor import CommonPreprocessor
from espnet_tpu_torch.frontends.default import (DefaultFrontend, GlobalMVN,
                                                UtteranceMVN)
from espnet_tpu_torch.models.asr import ENCODER_CLASSES, ASRModel
from espnet_tpu_torch.tasks.abs_task import AbsTask


def read_token_list(token_list) -> list:
    if isinstance(token_list, (list, tuple)):
        return list(token_list)
    lines = Path(token_list).read_text(encoding="utf-8").splitlines()
    return [ln for ln in lines if ln.strip()]


def _require(cfg, key, supported, default):
    value = cfg.get(key, default)
    if value not in supported:
        raise NotImplementedError(
            f"{key}={value!r}: the port builds {sorted(map(str, supported))}")
    return value


def fp32_and_deterministic():
    """fp32 means fp32: TF32 in matmuls or cuDNN convolutions would keep
    only ~3 decimal digits and break parity with the reference. And cuDNN
    takes only deterministic algorithms: the backward of the subsampling
    and depthwise convolutions may otherwise add in an order that changes
    between runs, and training on the card would not repeat itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def build_frontend(cfg: Dict[str, Any]):
    """-> (DefaultFrontend, GlobalMVN, UtteranceMVN or None, SpecAug conf
    or None): the feature path both ASR models share. ``global_mvn``
    without a stats file falls back to UtteranceMVN, as the JAX package's
    task does; UtteranceMVN takes its defaults, as there."""
    _require(cfg, "frontend", {"default"}, "default")
    normalize = _require(cfg, "normalize",
                         {"global_mvn", "utterance_mvn", None}, None)
    stats = None
    if normalize == "global_mvn":
        stats_file = cfg.get("stats_file") or (
            cfg.get("normalize_conf") or {}).get("stats_file")
        stats = (GlobalMVN.from_file(stats_file) if stats_file
                 else UtteranceMVN())
    elif normalize == "utterance_mvn":
        stats = UtteranceMVN()
    specaug = _require(cfg, "specaug", {"specaug", None}, None)
    return (DefaultFrontend(**dict(cfg.get("frontend_conf") or {})), stats,
            dict(cfg.get("specaug_conf") or {}) if specaug == "specaug"
            else None)


def build_model(cfg: Dict[str, Any]) -> ASRModel:
    fp32_and_deterministic()
    frontend, normalize, specaug_conf = build_frontend(cfg)
    encoder = _require(cfg, "encoder", set(ENCODER_CLASSES), "transformer")
    _require(cfg, "decoder", {"transformer", None}, "transformer")
    _require(cfg, "model", {None}, None)
    for key in ("preencoder", "postencoder"):
        _require(cfg, key, {None}, None)
    token_list = read_token_list(cfg["token_list"])
    mc = dict(cfg.get("model_conf") or {})
    if mc.get("interctc_weight", 0.0) or (cfg.get("ctc_conf") or {}):
        raise NotImplementedError("interCTC and ctc_conf are not ported")
    decoder_conf = (dict(cfg.get("decoder_conf") or {})
                    if cfg.get("decoder", "transformer") else None)
    return ASRModel(
        vocab_size=len(token_list), token_list=token_list,
        frontend=frontend, normalize=normalize,
        encoder_conf=dict(cfg.get("encoder_conf") or {}),
        decoder_conf=decoder_conf,
        ctc_weight=mc.get("ctc_weight", 0.5),
        specaug_conf=specaug_conf,
        lsm_weight=mc.get("lsm_weight", 0.0),
        length_normalized_loss=mc.get("length_normalized_loss", False),
        encoder=encoder)


class ASRTask(AbsTask):
    name = "asr"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "token_list": None,
            "token_type": "char",
            "bpemodel": None,
            "non_linguistic_symbols": [],
            "cleaner": None,
            "frontend": "default",
            "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
            "specaug": None,
            "specaug_conf": {},
            "normalize": "utterance_mvn",
            "normalize_conf": {},
            "stats_file": None,
            "encoder": "transformer",
            "encoder_conf": {},
            "decoder": "transformer",
            "decoder_conf": {},
            "model_conf": {"ctc_weight": 0.5, "lsm_weight": 0.0,
                           "interctc_weight": 0.0},
        }

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> ASRModel:
        return build_model(cfg)

    @classmethod
    def build_preprocess_fn(cls, cfg: Dict[str, Any], train: bool):
        if cfg.get("token_list") is None:
            return None
        return CommonPreprocessor(
            token_type=cfg.get("token_type", "char"),
            token_list=read_token_list(cfg["token_list"]),
            bpemodel=cfg.get("bpemodel"), text_cleaner=cfg.get("cleaner"),
            non_linguistic_symbols=cfg.get("non_linguistic_symbols") or ())
