"""LM task (counterpart of espnet_tpu/tasks/lm.py:LMTask): the token list
gives the vocabulary, ``lm``/``lm_conf`` the model, char tokens the text
preprocessor. ``build_model_from_file`` is AbsTask's, so a packed asset
dir (config.yaml, tokens.txt, params_f16.npz) loads strictly. The LM
trainer waits (ROADMAP A.5)."""

from __future__ import annotations

from typing import Any, Dict

from espnet_tpu_torch.data.preprocessor import CommonPreprocessor
from espnet_tpu_torch.models.lm import LanguageModel
from espnet_tpu_torch.tasks.abs_task import AbsTask
from espnet_tpu_torch.tasks.asr import fp32_and_deterministic, read_token_list


class LMTask(AbsTask):
    name = "lm"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {"token_list": None, "token_type": "char", "bpemodel": None,
                "lm": "transformer", "lm_conf": {}}

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> LanguageModel:
        fp32_and_deterministic()
        return LanguageModel(
            vocab_size=len(read_token_list(cfg["token_list"])),
            lm_type=cfg.get("lm", "transformer"),
            lm_conf=dict(cfg.get("lm_conf") or {}))

    @classmethod
    def build_preprocess_fn(cls, cfg: Dict[str, Any], train: bool):
        if cfg.get("token_list") is None:
            return None
        return CommonPreprocessor(
            token_type=cfg.get("token_type", "char"),
            token_list=read_token_list(cfg["token_list"]),
            bpemodel=cfg.get("bpemodel"))
