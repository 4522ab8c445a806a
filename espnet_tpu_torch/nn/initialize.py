"""Parameter initialisation for training from scratch, following flax's
defaults (the JAX package's ``model.init``) rather than torch's:

- Dense, Conv, ConvTranspose and DepthwiseConv1d kernels: lecun_normal,
  a normal truncated at two standard deviations and rescaled to variance
  1 / fan_in (flax's fan_in: every kernel axis but the output
  features'); zero biases;
- Embed: flax's default, a normal of variance 1 / features;
- ``pos_bias_u`` and ``pos_bias_v``: xavier_uniform;
- the hidden kernels of an LSTM cell (hi, hf, hg, ho): orthogonal, as
  flax's ``OptimizedLSTMCell`` has them; its input kernels lecun_normal;
- LayerNorm: ones and zeros.

The draws come from a seeded ``torch.Generator`` and are not flax's bits:
what matches is each initialiser's distribution.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from espnet_tpu_torch.models.transducer import LSTMCell
from espnet_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
from espnet_tpu_torch.nn.convolution import DepthwiseConv1d

# the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                  fan_in: int | None = None):
    """Truncated normal on [-2, 2] standard deviations, variance
    1 / fan_in, fan_in = in channels x receptive field (by default read
    from torch's (out, in, ...) layouts)."""
    if fan_in is None:
        fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    with torch.no_grad():
        # inverse CDF of the unit normal on a uniform draw in [Phi(-2), Phi(2)]
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        w.uniform_(2 * lo - 1, 1 - 2 * lo, generator=generator)
        w.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2 * std, 2 * std)


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator):
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter of ``model`` in place."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d,
                                   DepthwiseConv1d, nn.ConvTranspose1d)):
                w = module.weight
                # a transposed convolution's weight is (in, out, K)
                lecun_normal_(w, generator,
                              w.shape[0] * w.shape[2]
                              if isinstance(module, nn.ConvTranspose1d)
                              else None)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(
                    0.0, 1.0 / math.sqrt(module.weight.shape[1]),
                    generator=generator)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, RelPositionMultiHeadedAttention):
                xavier_uniform_(module.pos_bias_u, generator)
                xavier_uniform_(module.pos_bias_v, generator)
    for module in model.modules():   # after the Linears inside the cells
        if isinstance(module, LSTMCell):
            for gate in module.GATES:
                nn.init.orthogonal_(getattr(module, f"h{gate}").weight,
                                    generator=generator)
    return model
