"""Joint enhancement + ASR model (counterpart of
espnet_tpu/models/enh_s2t.py:EnhS2TModel).

The enhancement model separates the mixture and the hybrid CTC/attention
ASR model reads its first estimate: the loss is the ASR loss plus
``enh_weight`` times the enhancement criterion against ``speech_ref1``
when that is given. Both live in one module, ``enh`` and ``s2t``, so one
backward reaches both, and the beam search decodes through ``encode``.

``asr_conf`` takes the JAX package's ASRModel fields. The port builds the
default frontend (``frontend_conf``), SpecAug (``specaug_conf``), no
normalisation or GlobalMVN (``normalize: global_mvn`` with a
``stats_file``, or ``normalize_stats``, a GlobalMVN), the port's encoders
and the transformer decoder; anything else raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from espnet_tpu_torch.frontends.default import DefaultFrontend, GlobalMVN
from espnet_tpu_torch.models.asr import ENCODER_CLASSES, ASRModel
from espnet_tpu_torch.models.enh.losses import CRITERIA, pit_loss
from espnet_tpu_torch.models.enh.model import EnhancementModel

# the JAX package's ASRModel fields that the port takes, and those that it
# takes only at their defaults
_ASR_FIELDS = {"frontend", "frontend_conf", "specaug_conf", "normalize",
               "normalize_stats", "stats_file", "encoder", "encoder_conf",
               "decoder", "decoder_conf", "ctc_weight", "lsm_weight",
               "length_normalized_loss", "ignore_id", "blank_id"}
_ASR_DEFAULTS_ONLY = {"preencoder": None, "postencoder": None,
                      "ctc_conf": None, "interctc_weight": 0.0, "sos": None,
                      "eos": None, "preencoder_conf": None,
                      "postencoder_conf": None}


def build_asr(vocab_size: int, token_list, asr_conf: dict) -> ASRModel:
    """The port's ASRModel from the JAX package's ASRModel fields."""
    conf = dict(asr_conf)
    odd = sorted(k for k in conf if k not in _ASR_FIELDS
                 and (k not in _ASR_DEFAULTS_ONLY
                      or conf[k] not in (_ASR_DEFAULTS_ONLY[k], {})))
    if odd:
        raise NotImplementedError(f"asr_conf {odd}: not ported")
    if conf.get("frontend", "default") != "default" or \
            conf.get("frontend_conf") is None:
        raise NotImplementedError("the port's EnhS2T ASR branch needs the "
                                  "default frontend and its frontend_conf")
    normalize = conf.get("normalize")
    stats = None
    if normalize == "global_mvn":
        stats = conf.get("normalize_stats")
        if stats is None and conf.get("stats_file"):
            stats = GlobalMVN.from_file(conf["stats_file"])
        if not isinstance(stats, GlobalMVN):
            raise NotImplementedError("global_mvn without a stats_file")
    elif normalize is not None:
        raise NotImplementedError(f"normalize {normalize!r} is not ported")
    encoder = conf.get("encoder", "transformer")
    if encoder not in ENCODER_CLASSES:
        raise NotImplementedError(f"encoder {encoder!r} is not ported")
    decoder = conf.get("decoder", "transformer")
    if decoder not in ("transformer", None):
        raise NotImplementedError(f"decoder {decoder!r} is not ported")
    return ASRModel(
        vocab_size=vocab_size, token_list=token_list,
        frontend=DefaultFrontend(**dict(conf["frontend_conf"])),
        normalize=stats, encoder_conf=dict(conf.get("encoder_conf") or {}),
        decoder_conf=(dict(conf.get("decoder_conf") or {})
                      if decoder else None),
        ctc_weight=conf.get("ctc_weight", 0.5),
        blank_id=conf.get("blank_id", 0),
        specaug_conf=conf.get("specaug_conf"),
        lsm_weight=conf.get("lsm_weight", 0.0),
        length_normalized_loss=conf.get("length_normalized_loss", False),
        ignore_id=conf.get("ignore_id", -1), encoder=encoder)


class EnhS2TModel(nn.Module):

    def __init__(self, vocab_size: int, token_list=(),
                 enh_conf: Optional[dict] = None,
                 asr_conf: Optional[dict] = None, enh_weight: float = 0.2):
        super().__init__()
        ec = dict(enh_conf or {})
        ec.setdefault("num_spk", 1)
        self.enh = EnhancementModel(**ec)
        self.s2t = build_asr(vocab_size, tuple(token_list),
                             dict(asr_conf or {}))
        self.enh_weight = enh_weight

    # what the beam search reads of an ASR model
    @property
    def vocab_size(self) -> int:
        return self.s2t.vocab_size

    @property
    def token_list(self):
        return self.s2t.token_list

    @property
    def sos_id(self) -> int:
        return self.s2t.sos_id

    @property
    def eos_id(self) -> int:
        return self.s2t.eos_id

    @property
    def blank_id(self) -> int:
        return self.s2t.blank_id

    @property
    def ctc_weight(self) -> float:
        return self.s2t.ctc_weight

    @property
    def decoder_mod(self):
        return self.s2t.decoder_mod

    def encode(self, speech_mix, speech_lengths,
               generator: Optional[torch.Generator] = None):
        """Enhance, then the ASR encoder on the first estimate."""
        ests, olens, _ = self.enh.forward_enhance(speech_mix, speech_lengths)
        return self.s2t.encode(ests[0], olens, generator)

    def ctc_logits(self, enc):
        return self.s2t.ctc_logits(enc)

    def decoder_init_state(self, memory, memory_lens, batch: int,
                           maxlen: int):
        return self.s2t.decoder_init_state(memory, memory_lens, batch, maxlen)

    def decoder_score_step(self, token, step: int, state):
        return self.s2t.decoder_score_step(token, step, state)

    def forward(self, speech_mix, speech_mix_lengths, text, text_lengths,
                speech_ref1: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, **kw):
        """-> (loss, stats {asr_loss, asr_loss_ctc, ..., enh_loss, loss},
        weight = B)."""
        ests, olens, _ = self.enh.forward_enhance(speech_mix,
                                                  speech_mix_lengths)
        enc, enc_lens = self.s2t.encode(ests[0], olens, generator)
        loss, stats, weight = self.s2t.compute_losses(enc, enc_lens, text,
                                                      text_lengths)
        stats = {f"asr_{k}": v for k, v in stats.items()}
        if speech_ref1 is not None and self.enh_weight > 0.0:
            crit = CRITERIA[self.enh.loss_type]
            per_utt, _ = pit_loss(crit, ests[:1],
                                  [speech_ref1[:, :ests[0].shape[1]]],
                                  speech_mix_lengths)
            stats["enh_loss"] = per_utt.mean()
            loss = loss + self.enh_weight * stats["enh_loss"]
        stats["loss"] = loss
        return loss, stats, weight
