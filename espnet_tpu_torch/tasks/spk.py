"""Diarization task (counterpart of espnet_tpu/tasks/spk.py:
DiarizationTask): an EEND model over wave and (T, S) speaker-activity
labels read from an npy scp, collated at the config's fixed lengths. The
speaker, classification and LID tasks of that module wait (ROADMAP A.5:
ECAPA first)."""

from __future__ import annotations

from typing import Any, Dict

from espnet_tpu_torch.models.diar import DiarizationModel
from espnet_tpu_torch.tasks.abs_task import AbsTask
from espnet_tpu_torch.tasks.asr import fp32_and_deterministic


class DiarizationTask(AbsTask):
    name = "diar"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "num_spk": 2,
            "frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 23},
            "encoder": "transformer",
            "encoder_conf": {},
            "use_preprocessor": False,
        }

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> DiarizationModel:
        fp32_and_deterministic()
        return DiarizationModel(
            num_spk=cfg.get("num_spk", 2),
            frontend_conf=dict(cfg.get("frontend_conf") or {}),
            encoder=cfg.get("encoder", "transformer"),
            encoder_conf=dict(cfg.get("encoder_conf") or {}))
