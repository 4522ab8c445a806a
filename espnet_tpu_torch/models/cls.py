"""Audio classification and language identification (counterpart of
espnet_tpu/models/cls.py): frontend (the log-mel kernel K2 where the
frontend takes it) -> UtteranceMVN -> encoder -> the mean of the valid
frames -> a linear head; a softmax cross-entropy over one label, or with
``multilabel`` a sigmoid cross-entropy over each class."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.frontends.default import DefaultFrontend, UtteranceMVN
from espnet_tpu_torch.models.asr import ENCODER_CLASSES
from espnet_tpu_torch.utils.masks import make_non_pad_mask


class ClassificationModel(nn.Module):

    def __init__(self, n_classes: int, frontend_conf: Optional[dict] = None,
                 encoder: str = "transformer",
                 encoder_conf: Optional[dict] = None,
                 multilabel: bool = False):
        super().__init__()
        if encoder not in ENCODER_CLASSES:
            raise NotImplementedError(
                f"encoder {encoder!r}: the port has {sorted(ENCODER_CLASSES)}"
                f" (ROADMAP A.8)")
        fc = dict(frontend_conf or {"n_fft": 512, "hop_length": 128,
                                    "n_mels": 80})
        self.frontend = DefaultFrontend(**fc)
        self.normalize = UtteranceMVN()
        enc_conf = dict(encoder_conf or {})
        self.encoder_mod = ENCODER_CLASSES[encoder](self.frontend.output_size,
                                                    **enc_conf)
        self.classifier = nn.Linear(enc_conf.get("output_size", 256),
                                    n_classes)
        self.n_classes, self.multilabel = n_classes, multilabel

    def predict(self, speech, speech_lengths):
        """(B, S) wave, (B,) lengths -> (B, n_classes) logits."""
        feats, flens = self.frontend(speech, speech_lengths)
        feats, flens = self.normalize(feats, flens)
        enc, olens = self.encoder_mod(feats, flens)
        mask = make_non_pad_mask(olens, enc.shape[1])[:, :, None]
        pooled = torch.where(mask, enc, enc.new_zeros(())).sum(1) / \
            torch.clamp(mask.sum(1), min=1).to(enc.dtype)
        return self.classifier(pooled)

    def forward(self, speech, speech_lengths, label, label_lengths=None,
                generator: Optional[torch.Generator] = None):
        """label: (B,) or (B, 1) class ids, or (B, n_classes) 0/1 with
        ``multilabel`` -> (loss, {loss, acc}, B)."""
        logits = self.predict(speech, speech_lengths)
        y = label[:, 0] if (label.dim() > 1 and not self.multilabel) \
            else label
        if self.multilabel:
            yf = y.to(logits.dtype)
            loss = -torch.mean(yf * F.logsigmoid(logits)
                               + (1 - yf) * F.logsigmoid(-logits))
            acc = torch.mean(((logits > 0) == (y > 0)).to(logits.dtype))
        else:
            # the label's log-probability as a one-hot product: a gather's
            # scatter backward would be the only one here
            onehot = F.one_hot(y, self.n_classes).to(logits.dtype)
            loss = -torch.mean((torch.log_softmax(logits, -1)
                                * onehot).sum(-1))
            acc = torch.mean((torch.argmax(logits, -1) == y).to(
                logits.dtype))
        return loss, {"loss": loss, "acc": acc}, float(speech.shape[0])
