"""Speaker, diarization, classification and language-ID tasks
(counterpart of espnet_tpu/tasks/spk.py).

``SpeakerTask`` trains a speaker encoder through the AAM-softmax: its
``encoder_conf`` is cut to the chosen encoder's fields (the config's
deep merge keeps the ECAPA defaults around), the margin warms up from 0
in epoch 1 to ``aam_margin`` after ``margin_warmup_epochs`` (a
``margin`` in every train batch), and with ``valid_trial`` and
``valid_trial_scp`` each valid epoch scores the trial list by the cosine
of L2-normalised embeddings, one utterance a call, padded to its length
bucket (base 4096, x1.3), and reports its EER and minDCF.
``DiarizationTask`` is the EEND model over wave and (T, S) activity
labels. ``ClassificationTask`` classifies utterances (``label``: a class
id, or 0/1 per class with ``multilabel``); ``LIDTask`` is the same task
over languages.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from espnet_tpu_torch.models.cls import ClassificationModel
from espnet_tpu_torch.models.diar import DiarizationModel
from espnet_tpu_torch.models.spk import SpeakerModel, encoder_fields
from espnet_tpu_torch.tasks.abs_task import AbsTask
from espnet_tpu_torch.tasks.asr import fp32_and_deterministic

TRIAL_BUCKET_BASE = 4096
TRIAL_BUCKET_GROWTH = 1.3


def read_trials(path):
    """``label enroll_uttid test_uttid`` lines -> [(label, enroll, test)]."""
    trials = []
    for line in open(path, encoding="utf-8"):
        parts = line.split()
        if len(parts) >= 3:
            trials.append((int(parts[0]), parts[1], parts[2]))
    return trials


def trial_scores(embs, trials):
    """-> (cosine scores, labels) of the trials over L2-normalised
    embeddings {uttid: vector}."""
    labels = np.asarray([int(lab) for lab, _, _ in trials])
    scores = np.asarray([float(embs[e] @ embs[t]) for _, e, t in trials])
    return scores, labels


class SpeakerTask(AbsTask):
    name = "spk"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "n_spk": 2,
            "frontend_conf": {"n_fft": 512, "hop_length": 160, "n_mels": 80},
            "encoder": "ecapa",     # ecapa | rawnet3 | ska_tdnn | xvector
            "encoder_conf": {"channels": 128, "num_blocks": 2},
            "embed_dim": 64,
            "model_conf": {"aam_margin": 0.2, "aam_scale": 30.0},
            "margin_warmup_epochs": 0,
            "use_preprocessor": False,
        }

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> SpeakerModel:
        fp32_and_deterministic()
        mc = dict(cfg.get("model_conf") or {})
        enc = cfg.get("encoder", "ecapa")
        fields = encoder_fields(enc)
        ec = {k: v for k, v in dict(cfg.get("encoder_conf") or {}).items()
              if k in fields}
        return SpeakerModel(
            n_spk=cfg["n_spk"],
            frontend_conf=dict(cfg.get("frontend_conf") or {}),
            encoder_name=enc, encoder_conf=ec,
            embed_dim=cfg.get("embed_dim", 192),
            aam_margin=mc.get("aam_margin", 0.2),
            aam_scale=mc.get("aam_scale", 30.0))

    @classmethod
    def batch_extras_fn(cls, cfg):
        warm = int(cfg.get("margin_warmup_epochs") or 0)
        if warm <= 0:
            return None
        final = float(dict(cfg.get("model_conf") or {}).get("aam_margin",
                                                             0.2))

        def fn(epoch: int):
            m = final * min(max(epoch - 1, 0) / warm, 1.0)
            return {"margin": np.asarray(m, np.float32)}

        return fn

    @classmethod
    def build_extra_valid_fn(cls, cfg):
        trial_file, scp = cfg.get("valid_trial"), cfg.get("valid_trial_scp")
        if not trial_file or not scp:
            return None
        from espnet_tpu_torch.data.batching import bucket_length
        from espnet_tpu_torch.data.fileio import SoundScpReader
        from espnet_tpu_torch.utils.eer import compute_eer, compute_min_dcf

        trials = read_trials(trial_file)
        reader = SoundScpReader(scp)
        utt_ids = sorted({u for _, e, t in trials for u in (e, t)})

        @torch.no_grad()
        def fn(model, epoch):
            model.eval()
            device = next(model.parameters()).device
            embs = {}
            for u in utt_ids:
                wav = np.asarray(reader[u][1], np.float32)
                n = len(wav)
                L = bucket_length(n, base=TRIAL_BUCKET_BASE,
                                  growth=TRIAL_BUCKET_GROWTH)
                e = model.extract_embedding(
                    torch.from_numpy(np.pad(wav, (0, L - n))[None]).to(device),
                    torch.tensor([n], device=device))[0].cpu().numpy()
                embs[u] = e / max(np.linalg.norm(e), 1e-9)
            scores, labels = trial_scores(embs, trials)
            eer, _ = compute_eer(scores, labels)
            return {"eer": eer, "min_dcf": compute_min_dcf(scores, labels)}

        return fn


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


class ClassificationTask(AbsTask):
    name = "cls"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "n_classes": 10,
            "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
            "encoder": "transformer",
            "encoder_conf": {},
            "multilabel": False,
            "use_preprocessor": False,
        }

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> ClassificationModel:
        fp32_and_deterministic()
        return ClassificationModel(
            n_classes=cfg["n_classes"],
            frontend_conf=dict(cfg.get("frontend_conf") or {}),
            encoder=cfg.get("encoder", "transformer"),
            encoder_conf=dict(cfg.get("encoder_conf") or {}),
            multilabel=cfg.get("multilabel", False))


class LIDTask(ClassificationTask):
    """Language ID: single-label classification over languages."""

    name = "lid"
