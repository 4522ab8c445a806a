"""Transducer (RNN-T) model: encoder, prediction network and joint
(counterpart of espnet_tpu/models/transducer.py).

encode = frontend -> SpecAug (training only) -> GlobalMVN -> encoder, as
in the hybrid model; the prediction network runs over [blank, y...]; the
joint combines every encoder frame with every prediction step into
logits (B, T, U+1, V), and the loss is the RNN-T loss (K3 on the card)
plus ``aux_ctc_weight`` times CTC on the encoder output. Attribute names
follow the JAX parameter tree, so ``convert.py`` maps one onto the other
by path. The RWKV and MEGA prediction networks are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from espnet_tpu_torch.frontends.default import DefaultFrontend, GlobalMVN
from espnet_tpu_torch.models.asr import ENCODER_CLASSES, CTCHead
from espnet_tpu_torch.nn.embedding import OneHotEmbedding
from espnet_tpu_torch.ops.losses import ctc_loss
from espnet_tpu_torch.ops.rnnt import rnnt_loss
from espnet_tpu_torch.ops.specaug import specaug


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` in its parameter layout: input kernels
    ii/if/ig/io without bias, hidden kernels hi/hf/hg/ho with bias; the
    carry is (c, h), c' = f c + i g and h' = o tanh(c'). Written out
    rather than ``nn.LSTM``: the weights map one to one, and nothing runs
    through cuDNN's RNN."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        for gate in self.GATES:
            # "if" is a keyword: the submodules are named by add_module
            self.add_module(f"i{gate}", nn.Linear(input_size, hidden_size,
                                                  bias=False))
            self.add_module(f"h{gate}", nn.Linear(hidden_size, hidden_size))

    def input_proj(self, x):
        """The input kernels of all four gates at once, plus the hidden
        biases: (..., 4H), formed once for every step of a sequence."""
        w = torch.cat([getattr(self, f"i{g}").weight for g in self.GATES])
        b = torch.cat([getattr(self, f"h{g}").bias for g in self.GATES])
        return x @ w.t() + b

    def hidden_kernel(self):
        """The hidden kernels of all four gates, transposed: (H, 4H)."""
        return torch.cat([getattr(self, f"h{g}").weight
                          for g in self.GATES]).t()

    def forward(self, carry, x_proj, hidden_kernel=None):
        """carry (c, h), x_proj = input_proj(x) -> (c', h'): one addmm
        and one sigmoid over the four gates. A caller that steps many
        times passes ``hidden_kernel()`` once."""
        c, h = carry
        wt = self.hidden_kernel() if hidden_kernel is None else hidden_kernel
        z = torch.addmm(x_proj, h, wt)
        H = c.shape[-1]
        gates = torch.sigmoid(z)
        c = gates[:, H:2 * H] * c + gates[:, :H] * torch.tanh(
            z[:, 2 * H:3 * H])
        return c, gates[:, 3 * H:] * torch.tanh(c)


class RNNDecoder(nn.Module):
    """LSTM prediction network: embedding, then ``num_layers`` cells."""

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_layers: int = 1, embed_size: Optional[int] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        emb = embed_size or hidden_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.embed = OneHotEmbedding(vocab_size, emb)
        for i in range(num_layers):
            self.add_module(f"rnn{i}", LSTMCell(emb if i == 0 else
                                                hidden_size, hidden_size))
        self.dropout = nn.Dropout(dropout_rate)

    @property
    def output_size(self) -> int:
        return self.hidden_size

    def cells(self):
        return [getattr(self, f"rnn{i}") for i in range(self.num_layers)]

    def init_carry(self, batch: int, device=None):
        zeros = torch.zeros(batch, self.hidden_size, device=device,
                            dtype=self.embed.weight.dtype)
        return [(zeros, zeros) for _ in range(self.num_layers)]

    def step(self, carry, token):
        """token (B,) -> (out (B, H), new carry)."""
        h = self.embed(token)
        new_carry = []
        for cell, c in zip(self.cells(), carry):
            c = cell(c, cell.input_proj(h))
            new_carry.append(c)
            h = c[1]
        return h, new_carry

    def forward(self, labels_in):
        """labels_in (B, U+1) = [blank, y...] -> (B, U+1, H)."""
        B, U1 = labels_in.shape
        h = self.dropout(self.embed(labels_in))
        for cell, carry in zip(self.cells(),
                               self.init_carry(B, labels_in.device)):
            x_proj = cell.input_proj(h)       # every step's input at once
            outs = []
            for t in range(U1):
                carry = cell(carry, x_proj[:, t])
                outs.append(carry[1])
            h = torch.stack(outs, dim=1)
        return h


class StatelessDecoder(nn.Module):
    """Embedding-only prediction network."""

    def __init__(self, vocab_size: int, embed_size: int = 256,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.embed_size = embed_size
        self.embed = OneHotEmbedding(vocab_size, embed_size)
        self.dropout = nn.Dropout(dropout_rate)

    @property
    def output_size(self) -> int:
        return self.embed_size

    def init_carry(self, batch: int, device=None):
        return [torch.zeros(batch, 0, device=device)]

    def step(self, carry, token):
        return self.embed(token), carry

    def forward(self, labels_in):
        return self.dropout(self.embed(labels_in))


ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu,
               "swish": nn.functional.silu}


class JointNetwork(nn.Module):
    """joint(enc, dec) = W_out act(W_enc enc + W_dec dec), broadcasting
    enc (..., De) against dec (..., Dd)."""

    def __init__(self, vocab_size: int, encoder_size: int, decoder_size: int,
                 joint_space_size: int = 256, activation: str = "tanh"):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.lin_enc = nn.Linear(encoder_size, joint_space_size)
        self.lin_dec = nn.Linear(decoder_size, joint_space_size)
        self.lin_out = nn.Linear(joint_space_size, vocab_size)

    def forward(self, enc, dec):
        return self.lin_out(self.act(self.lin_enc(enc) + self.lin_dec(dec)))


DECODER_CLASSES = {"rnn": RNNDecoder, "stateless": StatelessDecoder}


class TransducerModel(nn.Module):

    def __init__(self, vocab_size: int, token_list, frontend: DefaultFrontend,
                 normalize: Optional[GlobalMVN], encoder: str,
                 encoder_conf: dict, decoder: str = "rnn",
                 decoder_conf: Optional[dict] = None,
                 joint_conf: Optional[dict] = None,
                 specaug_conf: Optional[dict] = None, blank_id: int = 0,
                 aux_ctc_weight: float = 0.0):
        super().__init__()
        self.vocab_size = vocab_size
        self.token_list = tuple(token_list)
        self.blank_id = blank_id
        self.aux_ctc_weight = aux_ctc_weight
        self.specaug_conf = specaug_conf
        self.frontend = frontend
        self.normalize = normalize
        self.encoder_mod = ENCODER_CLASSES[encoder](frontend.output_size,
                                                    **encoder_conf)
        d_enc = encoder_conf.get("output_size", 256)
        self.decoder_mod = DECODER_CLASSES[decoder](
            vocab_size, **dict(decoder_conf or {}))
        self.joint = JointNetwork(vocab_size, d_enc,
                                  self.decoder_mod.output_size,
                                  **dict(joint_conf or {}))
        self.ctc = CTCHead(d_enc, vocab_size) if aux_ctc_weight > 0 else None

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """(B, S) wave, (B,) lengths -> (B, T', D), (B,) lengths. SpecAug
        runs in training only, drawing from ``generator``."""
        feats, feat_lens = self.frontend(speech, speech_lengths)
        if self.training and self.specaug_conf is not None:
            feats = specaug(feats, feat_lens, generator=generator,
                            **self.specaug_conf)
        if self.normalize is not None:
            feats, feat_lens = self.normalize(feats, feat_lens)
        return self.encoder_mod(feats, feat_lens)

    def lattice_logits(self, enc, text):
        """enc (B, T, De), text (B, U) -> the joint's logits (B, T, U+1, V)
        of every frame against every step of [blank, y...]."""
        B = text.shape[0]
        labels_in = torch.cat([text.new_full((B, 1), self.blank_id), text],
                              dim=1)
        dec_out = self.decoder_mod(labels_in)
        return self.joint(enc[:, :, None, :], dec_out[:, None, :, :])

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None):
        """-> (loss, stats {loss_rnnt, loss_aux_ctc, loss}, weight = B)."""
        enc, enc_lens = self.encode(speech, speech_lengths, generator)
        B = text.shape[0]
        logits = self.lattice_logits(enc, text)
        loss_rnnt = rnnt_loss(logits, text, enc_lens, text_lengths,
                              self.blank_id)
        stats = {"loss_rnnt": loss_rnnt}
        loss = loss_rnnt
        if self.ctc is not None:
            loss_ctc = ctc_loss(self.ctc(enc), enc_lens, text, text_lengths,
                                self.blank_id)
            stats["loss_aux_ctc"] = loss_ctc
            loss = loss + self.aux_ctc_weight * loss_ctc
        stats["loss"] = loss
        return loss, stats, float(B)

    # -- decode-time delegation ---------------------------------------
    def decoder_init_carry(self, batch: int, device=None):
        return self.decoder_mod.init_carry(batch, device)

    def decoder_step(self, carry, token):
        return self.decoder_mod.step(carry, token)

    def joint_step(self, enc_frame, dec_out):
        """enc_frame (B, De), dec_out (B, Dd) -> (B, V) logits."""
        return self.joint(enc_frame, dec_out)
