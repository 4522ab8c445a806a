"""Enhancement model: encoder -> separator -> decoder, trained with PIT
(counterpart of espnet_tpu/models/enh/model.py:EnhancementModel).

Encoders: "stft" (the separator masks the magnitude; each mask scales the
complex spectrum, and the iSTFT gives the wave) and "conv" (Conv-TasNet:
a strided convolution and a ReLU make the representation the separator
masks, and a transposed convolution with the learned basis adds the
frames back). A separator's class attributes say what it takes and gives
(``separators.py``): ``complex_input`` ones take the (real, imag)
spectrum instead of the magnitude; "mask" outputs scale the spectrum,
"complex_mask" ones multiply it as complex numbers, "spectrum" ones are
the estimates themselves, and a "dpcl" embedding is clustered by
k-means into binary masks. ``needs_ref_spectra`` separators (DAN) take
the references' STFT magnitudes in training. ``loss_type: dpcl`` trains
a DPCL embedding with the affinity loss instead of a signal criterion.
The conv encoder takes only real-mask separators (ValueError otherwise,
as in the JAX package). The JAX package's time-domain and multichannel
separators raise NotImplementedError when built (ROADMAP A.4), so the
model has no branch for them; a multichannel mixture goes through its
channel 0, as in the JAX package.

The conv encoder's ``basis`` is a torch ConvTranspose1d, which adds
x[t] w[k] at t * stride + k; flax's ConvTranspose (transpose_kernel
False) runs the kernel unflipped over the dilated input, so its kernel
is this one reversed in k (``convert.py`` flips it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.models.enh.losses import CRITERIA, pit_loss
from espnet_tpu_torch.models.enh.separators import (SEPARATORS, dpcl_loss,
                                                    kmeans_tf_bins)
from espnet_tpu_torch.ops.stft import istft, stft


class EnhancementModel(nn.Module):

    def __init__(self, num_spk: int = 2, encoder: str = "stft",
                 n_fft: int = 512, hop_length: int = 128,
                 conv_channels: int = 256, conv_kernel: int = 32,
                 conv_stride: int = 16, separator: str = "rnn",
                 separator_conf: Optional[dict] = None,
                 loss_type: str = "si_snr"):
        super().__init__()
        if encoder not in ("stft", "conv"):
            raise ValueError(f"encoder {encoder!r}: 'stft' or 'conv'")
        if loss_type not in CRITERIA and loss_type != "dpcl":
            raise ValueError(f"loss_type {loss_type!r}: the port has "
                             f"{sorted(CRITERIA) + ['dpcl']}")
        self.num_spk = num_spk
        self.encoder = encoder
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.conv_kernel = conv_kernel
        self.conv_stride = conv_stride
        self.loss_type = loss_type
        if encoder == "conv":
            in_dim = conv_channels
            self.filterbank = nn.Conv1d(1, conv_channels, conv_kernel,
                                        stride=conv_stride, bias=False)
            self.basis = nn.ConvTranspose1d(conv_channels, 1, conv_kernel,
                                            stride=conv_stride, bias=False)
        else:
            in_dim = n_fft // 2 + 1
        self.separator_mod = SEPARATORS[separator](
            input_dim=in_dim, num_spk=num_spk, **dict(separator_conf or {}))
        sep = self.separator_mod
        if encoder == "conv" and (
                getattr(sep, "complex_input", False)
                or getattr(sep, "output", "mask") != "mask"
                or getattr(sep, "needs_ref_spectra", False)):
            raise ValueError(
                f"encoder='conv' requires a real-mask separator; "
                f"{separator!r} uses complex_input/output="
                f"{getattr(sep, 'output', 'mask')!r} - use encoder='stft' "
                f"for it")

    def forward_enhance(self, speech_mix: torch.Tensor,
                        speech_lengths: torch.Tensor, refs=None):
        """-> (list over speakers of (B, S) estimates, lengths, masks).
        ``refs`` (a list of (B, S) references) reach a
        ``needs_ref_spectra`` separator as STFT magnitudes; without them
        it takes its inference route."""
        if speech_mix.dim() == 3:
            speech_mix = speech_mix[..., 0]
        if self.encoder == "conv":
            return self._enhance_time_domain(speech_mix, speech_lengths)
        real, imag, _ = stft(speech_mix, speech_lengths, n_fft=self.n_fft,
                             hop_length=self.hop_length)
        sep = self.separator_mod
        if getattr(sep, "complex_input", False):
            feats = (real, imag)
        else:
            feats = torch.sqrt(real * real + imag * imag + 1e-8)
        kw = {}
        if getattr(sep, "needs_ref_spectra", False) and refs is not None:
            kw["refs_mag"] = [self._ref_mag(r) for r in refs]
        masks = sep(feats, **kw)
        out_kind = getattr(sep, "output", "mask")
        if out_kind == "dpcl":
            # the bins' embedding clustered into binary masks
            B, T, Fq, D = masks.shape
            lab, _ = kmeans_tf_bins(masks.reshape(B, T * Fq, D),
                                    self.num_spk)
            lab = lab.reshape(B, T, Fq)
            masks = [(lab == s).to(real.dtype) for s in range(self.num_spk)]
            out_kind = "mask"
        S = speech_mix.shape[1]
        ests = []
        for m in masks:
            if out_kind == "spectrum":
                er, ei = m
            elif out_kind == "complex_mask":
                mr, mi = m
                er, ei = real * mr - imag * mi, real * mi + imag * mr
            else:
                er, ei = real * m, imag * m
            ests.append(istft(er, ei, n_fft=self.n_fft,
                              hop_length=self.hop_length, length=S))
        return ests, speech_lengths, masks

    def _ref_mag(self, ref):
        r, i, _ = stft(ref, None, n_fft=self.n_fft,
                       hop_length=self.hop_length)
        return torch.sqrt(r * r + i * i + 1e-8)

    def _enhance_time_domain(self, speech_mix, speech_lengths):
        """Pad so that the VALID analysis frames cover every sample, mask
        the ReLU of the filterbank's output, add back with the basis."""
        S = speech_mix.shape[1]
        K, st = self.conv_kernel, self.conv_stride
        T = max(-(-max(S - K, 0) // st) + 1, 1)
        x = F.pad(speech_mix, (0, (T - 1) * st + K - S))[:, None]
        feats = F.relu(self.filterbank(x)).transpose(1, 2)   # (B, T, N)
        masks = self.separator_mod(feats)
        ests = [self.basis((feats * m).transpose(1, 2))[:, 0, :S]
                for m in masks]
        return ests, speech_lengths, masks

    def forward(self, speech_mix, speech_mix_lengths, speech_ref1,
                speech_ref2=None, generator=None, **kw):
        """-> (loss, stats {loss, si_snr}, weight = B). References come
        as speech_ref{n}; other batch entries (their lengths) are not
        read. With loss_type dpcl the loss is the affinity loss of the
        separator's embedding, and stats hold the loss alone."""
        refs = [speech_ref1]
        if speech_ref2 is not None and self.num_spk >= 2:
            refs.append(speech_ref2)
        if self.loss_type == "dpcl":
            real, imag, _ = stft(speech_mix, speech_mix_lengths,
                                 n_fft=self.n_fft,
                                 hop_length=self.hop_length)
            emb = self.separator_mod(torch.sqrt(real * real + imag * imag
                                                + 1e-8))
            loss = dpcl_loss(emb, [self._ref_mag(r) for r in refs]).mean()
            return loss, {"loss": loss}, float(speech_mix.shape[0])
        ests, _, _ = self.forward_enhance(speech_mix, speech_mix_lengths,
                                          refs=refs)
        loss_fn = CRITERIA[self.loss_type]
        if len(refs) > 1:
            per_utt, _ = pit_loss(loss_fn, ests[:len(refs)], refs,
                                  speech_mix_lengths)
        else:
            per_utt = loss_fn(ests[0], refs[0], speech_mix_lengths)
        loss = per_utt.mean()
        stats = {"loss": loss}
        if self.loss_type in ("si_snr", "snr"):
            stats["si_snr"] = -loss
        return loss, stats, float(speech_mix.shape[0])
