"""The grad check's ReLU pin and its float64 reference.

A ReLU has no derivative at 0, and fp32 rounding decides on which side
of it a pre-activation within ~1e-7 of 0 falls: two backwards of one
model on two devices may then differ by a whole unit's term in the
gradient of the weights before it, though both are right. So a check of
one backward against another lets one leg note the side of every ReLU
input (``pin_relus`` with no ``moved``) and moves the other legs'
pre-activations onto those sides (``take_side``), by no more than their
rounding: MOVE_TOL bounds each module's largest move, relative to the
module's largest |pre-activation|. ``pin_estimates`` gives a joint
model's ASR branch the same separated wave on every leg, and
``pin_attention`` every rel-pos self-attention the same inputs.
``pin_kinks`` does for the GAN models what ``pin_relus`` does: it moves
the input of every leaky ReLU (slope 0.1) onto the noted side of 0 and
that of every +-7 clip of a log-scale into the noted region, call by
call (a discriminator runs twice a turn); ``pin_alignment`` gives VITS's
alignment search the noted path, an argmax that a rounding may flip.
``to_float64`` makes a model the float64 reference of the fp32 legs.

chip_smoke.py's grad_check, tools/grad_drift.py and the tests use these.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from espnet_tpu_torch.models.enh.separators import (ConformerSeparator,
                                                    SVoiceSeparator,
                                                    TCNBlock, TCNSeparator,
                                                    TFGridNetSeparator,
                                                    TransformerSeparator,
                                                    _GridBlockV2)
from espnet_tpu_torch.models.spk import (EcapaEncoder, SERes2NetBlock,
                                          SkaTdnnEncoder)
from espnet_tpu_torch.models.tts.fastspeech2 import VariancePredictor
from espnet_tpu_torch.models.tts.hifigan import LeakyReLU
from espnet_tpu_torch.models.tts.vits import LOGS_CLIP, VITS, Clip
from espnet_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
from espnet_tpu_torch.nn.subsampling import Conv2dSubsampling
from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward

# a move onto the other side of 0 is at most a pre-activation's rounding:
# fp32 sums round at ~1e-7 of their terms, the card's and the CPU's
# log-mel features differ by ~1e-5 of their largest; a pin that took the
# sides of another batch or model would move units by ~1 of that
MOVE_TOL = 1e-5


def relu_inputs(model) -> dict:
    """The modules whose outputs go into a ReLU or a PReLU (a kink at 0
    too): the subsampling's two convolutions, the first linear of each
    ReLU feed-forward, and in the TCN separator the 1x1 and depthwise
    convolutions of each block, the last block (its output goes into the
    PReLU before the masks) and the mask convolution of ReLU masks; the
    mask heads of the Conformer and Transformer separators' ReLU masks
    (and the Transformer's linear input, a ReLU after its LayerNorm);
    TF-GridNet's and each TF-GridNetV2 block's attention projections
    (each into a PReLU); SVoice's encoder (into a ReLU) and its last
    block's LayerNorm (into the PReLU before the speakers' head); each
    convolution of a variance (duration) predictor; in a speaker
    encoder (ECAPA, SKA-TDNN) the input normalisation and the output
    convolution, and in each SE-Res2Net block both normalisations and the
    squeeze-excitation's first linear."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, SERes2NetBlock):
            out.update({f"{name}.{c}": getattr(m, c)
                        for c in ("norm1", "norm2", "se1")})
        elif isinstance(m, (EcapaEncoder, SkaTdnnEncoder)):
            out.update({f"{name}.norm_in": m.norm_in, f"{name}.mfa": m.mfa})
        elif isinstance(m, VariancePredictor):
            out.update({f"{name}.conv{i}": getattr(m, f"conv{i}")
                        for i in range(m.layers)})
        elif isinstance(m, Conv2dSubsampling):
            out.update({f"{name}.conv0": m.conv0, f"{name}.conv1": m.conv1})
        elif isinstance(m, PositionwiseFeedForward) and m.act is F.relu:
            out[f"{name}.w_1"] = m.w_1
        elif isinstance(m, TCNBlock):
            out.update({f"{name}.conv1x1": m.conv1x1,
                        f"{name}.dconv": m.dconv})
        elif isinstance(m, TCNSeparator):
            last = m.blocks[-1]
            out[f"{name}.{last}"] = getattr(m, last)
            if m.nonlinear == "relu":
                out[f"{name}.mask_out"] = m.mask_out
        elif isinstance(m, (ConformerSeparator, TransformerSeparator)):
            if m.nonlinear == "relu":
                out.update({f"{name}.mask{s}": getattr(m, f"mask{s}")
                            for s in range(m.num_spk)})
            if isinstance(m, TransformerSeparator):
                out[f"{name}.enc.embed_norm"] = m.enc.embed_norm
        elif isinstance(m, SVoiceSeparator):
            last = f"norm_o{m.num_layers - 1}"
            out.update({f"{name}.encoder": m.encoder,
                        f"{name}.{last}": getattr(m, last)})
        elif isinstance(m, (TFGridNetSeparator, _GridBlockV2)):
            out.update({f"{name}.{c}": sub
                        for c, sub in m.named_children()
                        if c.startswith("attn") and c[4] in "QKVO"
                        and isinstance(sub, torch.nn.Linear)})
    return out


def take_side(out, want):
    """``out`` moved onto the side of 0 that ``want`` gives (True: above
    0, False: below it, each by at least the smallest normal float), with
    an identity gradient. The value is the side itself: adding the move
    to ``out`` would round a move of a negative value to +tiny back to 0,
    which a ReLU masks. Strictly below 0, because a PReLU (flax's, and
    the port's) takes 0 on its positive side: a unit moved to exactly 0
    would take the other branch of its gradient there."""
    tiny = torch.finfo(out.dtype).tiny
    side = torch.where(want, out.clamp(min=tiny), out.clamp(max=-tiny))
    return side.detach() + (out - out.detach())


def pin_relus(modules: dict, signs: dict, moved: dict | None = None) -> list:
    """Forward hooks on ``modules`` ({name: module}, as relu_inputs
    gives). With ``moved`` None each notes its output's sides in
    ``signs``; else each moves its output onto the sides ``signs`` holds
    (take_side) and, where that moved a unit, sets ``moved[name]`` to
    [units moved, the largest |pre-activation| moved, that over the
    output's largest |entry|]. Returns the hooks' handles."""
    def hook(name):
        def pin(module, args, out):
            if moved is None:
                # an exact 0 goes below 0 here too, as on the other legs
                signs[name] = out > 0
                return take_side(out, signs[name])
            want = signs[name].to(out.device)
            flip = want != (out > 0)
            if bool(flip.any()):
                value = out.detach().abs()
                largest = float(value[flip].max())
                moved[name] = [int(flip.sum()), largest,
                               largest / float(value.max())]
            return take_side(out, want)
        return pin
    return [mod.register_forward_hook(hook(name))
            for name, mod in modules.items()]


def _region(x, module):
    """The side of a leaky ReLU's kink (1 above 0, else 0), or the region
    of a clip (-1 below -7, 0 within, 1 above 7)."""
    if isinstance(module, LeakyReLU):
        return (x > 0).to(torch.int8)
    return ((x > LOGS_CLIP).to(torch.int8)
            - (x < -LOGS_CLIP).to(torch.int8))


def _into(x, want, module):
    """``x`` moved into the regions ``want``, with an identity gradient."""
    if isinstance(module, LeakyReLU):
        return take_side(x, want == 1)
    over = torch.nextafter(torch.tensor(LOGS_CLIP, dtype=x.dtype),
                           torch.tensor(float("inf"), dtype=x.dtype)).item()
    side = torch.where(want == 1, x.clamp(min=over),
                       torch.where(want == -1, x.clamp(max=-over),
                                   x.clamp(-LOGS_CLIP, LOGS_CLIP)))
    return side.detach() + (x - x.detach())


def kink_modules(model) -> dict:
    """{name: module} of every LeakyReLU and Clip in ``model``."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, (LeakyReLU, Clip))}


def pin_kinks(modules: dict, regions: dict, moved: dict | None = None
              ) -> list:
    """Forward pre-hooks on ``modules`` (kink_modules): with ``moved``
    None each notes its input's regions in ``regions`` under
    "<name>#<call>"; else each moves its input into the noted regions
    and, where that moved an entry, sets ``moved`` of its key to [entries
    moved, the largest distance to the kink moved across, that over the
    input's largest |entry|]. Returns the handles."""
    def hook(name):
        calls = [0]

        def pin(module, args):
            key = f"{name}#{calls[0]}"
            calls[0] += 1
            x = args[0]
            if moved is None:
                regions[key] = _region(x.detach(), module).cpu()
                return None
            want = regions[key].to(x.device)
            flip = want != _region(x.detach(), module)
            if bool(flip.any()):
                kink = 0.0 if isinstance(module, LeakyReLU) else LOGS_CLIP
                value = x.detach().abs()
                largest = float((value[flip] - kink).abs().max())
                moved[key] = [int(flip.sum()), largest,
                              largest / float(value.max())]
            return (_into(x, want, module),)
        return pin
    return [mod.register_forward_pre_hook(hook(name))
            for name, mod in modules.items()]


def pin_alignment(model, store: dict, moved: dict | None = None) -> list:
    """Each VITS in ``model``: with ``moved`` None its alignment paths are
    noted in ``store``; else its own search runs and the noted path is
    used, and where the two differ ``moved["<name>.align"]`` is [frames
    on another token, utterances]. Returns the handles."""
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, VITS):
            key = f"{name}.align"

            def align(neg_cent, text_lengths, spec_lengths, key=key,
                      own=mod.align):
                path = own(neg_cent, text_lengths, spec_lengths)
                if moved is None:
                    store[key] = path.cpu()
                    return path
                want = store[key].to(path.device, path.dtype)
                differ = (want != path).any(dim=1)
                if bool(differ.any()):
                    moved[key] = [int(differ.sum()),
                                  int(differ.any(dim=1).sum())]
                return want

            mod.align = align
            handles.append(_Restore(mod, "align"))
    return handles


def pin_codes(model, store: dict, moved: dict | None = None) -> list:
    """Each ResidualVQ's codes, pinned as the alignment path is: with
    ``moved`` None noted per stage in ``store``; else the noted codes
    are used, and where its own argmin differs
    ``moved["<name>.codes"]`` is [codes moved, stages]. Returns the
    handles."""
    from espnet_tpu_torch.models.codec import ResidualVQ
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, ResidualVQ):
            key = f"{name}.codes"

            def nearest(q, r, cb, key=key, own=mod.nearest):
                idx = own(q, r, cb)
                if moved is None:
                    store[f"{key}{q}"] = idx.cpu()
                    return idx
                want = store[f"{key}{q}"].to(idx.device)
                n = int((want != idx).sum())
                if n:
                    row = moved.setdefault(key, [0, 0])
                    row[0] += n
                    row[1] += 1
                return want

            mod.nearest = nearest
            handles.append(_Restore(mod, "nearest"))
    return handles


class _Restore:
    """A handle whose remove() takes an instance's own attribute away
    again, leaving its class's."""

    def __init__(self, obj, name):
        self.obj, self.name = obj, name

    def remove(self):
        delattr(self.obj, self.name)


def _pinned(key: str, tensors, store: dict, moved: dict | None) -> list:
    """``tensors`` pinned under ``key``: with ``moved`` None noted in
    ``store`` and returned; else each replaced by its noted values, with
    an identity gradient, and where that moved an entry ``moved[key]``
    set to [entries moved, the largest move, that over the largest
    |entry|]. Entries at the padding's -1e9 bias are left out of the
    move and the scale."""
    if moved is None:
        store[key] = [t.detach().cpu() for t in tensors]
        return list(tensors)
    out, n_moved, largest, scale = [], 0, 0.0, 0.0
    for t, want in zip(tensors, store[key]):
        want = want.to(t.device, t.dtype)
        real = want > -1e8
        diff = (t.detach() - want).abs() * real
        n_moved += int((diff > 0).sum())
        largest = max(largest, float(diff.max()))
        scale = max(scale, float((want.abs() * real).max()))
        out.append(want + (t - t.detach()))
    if n_moved:
        moved[key] = [n_moved, largest, largest / max(scale, 1e-30)]
    return out


def pin_estimates(model, store: dict, moved: dict | None = None) -> list:
    """A joint enhancement + ASR model's separated estimates, pinned as
    the ReLU inputs are: with ``moved`` None the leg notes them in
    ``store``; else the leg's own estimates are replaced by the noted
    ones (their values, with an identity gradient), so the ASR branch of
    every leg reads the same wave, and where that moved a sample
    ``moved["enh.estimates"]`` is [samples moved, the largest move, that
    over the estimates' largest |entry|]. A model without ``enh`` gets no
    pin. Returns the handles."""
    enh = getattr(model, "enh", None)
    if enh is None:
        return []
    own = enh.forward_enhance

    def enhance(speech, lengths):
        ests, olens, masks = own(speech, lengths)
        return (_pinned("enh.estimates", ests, store, moved), olens,
                masks)

    enh.forward_enhance = enhance
    return [_Restore(enh, "forward_enhance")]


def pin_attention(model, store: dict, moved: dict | None = None) -> list:
    """Each rel-pos self-attention's kernel inputs (q + u, k, v and the
    positional bias), pinned as the estimates are, under
    "<module>.kernel_inputs". A trained Conformer's attention scores reach
    ~1e3 and most rows put > 0.99 on one key: there the gradients of q
    and k turn the fp32 rounding of the forward's projections (~1e-7 of
    ~1e3) into ~1e-3 of their own scale, so two legs that differ only
    there disagree by more than the check's tolerance. With one set of
    inputs each leg's attention backward is compared on its own.
    Returns the handles."""
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, RelPositionMultiHeadedAttention):
            own = mod.kernel_inputs

            def inputs(*args, own=own, key=f"{name}.kernel_inputs"):
                *tensors, sm_scale = own(*args)
                return (*_pinned(key, tensors, store, moved), sm_scale)

            mod.kernel_inputs = inputs
            handles.append(_Restore(mod, "kernel_inputs"))
    return handles


def _double(x):
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def to_float64(model):
    """``model`` in float64, taking its float inputs as float64 (the
    frontend then computes its STFT and log-mel in float64 too): a
    reference for the fp32 legs."""
    model.double()
    model.register_forward_pre_hook(
        lambda module, args, kwargs: (tuple(map(_double, args)),
                                      {k: _double(v)
                                       for k, v in kwargs.items()}),
        with_kwargs=True)
    return model
