"""Codec task (counterpart of espnet_tpu/tasks/ssl.py:CodecTask): a plain
AbsTask (one optimizer, the codec's reconstruction loss), not the GAN
trainer. The SSL tasks of that module (HuBERT, wav2vec 2.0, BEATs) wait
(ROADMAP A.8)."""

from __future__ import annotations

from typing import Any, Dict

from espnet_tpu_torch.models.codec import CodecModel
from espnet_tpu_torch.tasks.abs_task import AbsTask
from espnet_tpu_torch.tasks.asr import fp32_and_deterministic


class CodecTask(AbsTask):
    name = "gan_codec"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {"fs": 16000, "codec_conf": {}, "use_preprocessor": False}

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> CodecModel:
        fp32_and_deterministic()
        return CodecModel(fs=cfg.get("fs", 16000),
                          **dict(cfg.get("codec_conf") or {}))
