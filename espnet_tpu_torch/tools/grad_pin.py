"""The grad check's ReLU pin and its float64 reference.

A ReLU has no derivative at 0, and fp32 rounding decides on which side
of it a pre-activation within ~1e-7 of 0 falls: two backwards of one
model on two devices may then differ by a whole unit's term in the
gradient of the weights before it, though both are right. So a check of
one backward against another lets one leg note the side of every ReLU
input (``pin_relus`` with no ``moved``) and moves the other legs'
pre-activations onto those sides (``take_side``), by no more than their
rounding: MOVE_TOL bounds each module's largest move, relative to the
module's largest |pre-activation|. ``to_float64`` makes a model the
float64 reference of the fp32 legs.

chip_smoke.py's grad_check, tools/grad_drift.py and the tests use these.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from espnet_tpu_torch.nn.subsampling import Conv2dSubsampling
from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward

# a move onto the other side of 0 is at most a pre-activation's rounding:
# fp32 sums round at ~1e-7 of their terms, the card's and the CPU's
# log-mel features differ by ~1e-5 of their largest; a pin that took the
# sides of another batch or model would move units by ~1 of that
MOVE_TOL = 1e-5


def relu_inputs(model) -> dict:
    """The modules whose outputs go into a ReLU: the subsampling's two
    convolutions and the first linear of each ReLU feed-forward."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2dSubsampling):
            out.update({f"{name}.conv0": m.conv0, f"{name}.conv1": m.conv1})
        elif isinstance(m, PositionwiseFeedForward) and m.act is F.relu:
            out[f"{name}.w_1"] = m.w_1
    return out


def take_side(out, want):
    """``out`` moved onto the side of 0 that ``want`` gives (True: above
    0, by at least the smallest normal float; False: at or below it),
    with an identity gradient. The value is the side itself: adding the
    move to ``out`` would round a move of a negative value to +tiny back
    to 0, which a ReLU masks."""
    side = torch.where(want, out.clamp(min=torch.finfo(out.dtype).tiny),
                       out.clamp(max=0.0))
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
                signs[name] = out > 0
                return None
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


def to_float64(model):
    """``model`` in float64, its encoder taking the fp32 features of the
    frontend (which the log-mel computes in fp32) as float64: a
    reference for the fp32 legs."""
    model.double()
    model.encoder_mod.register_forward_pre_hook(
        lambda module, args: (args[0].double(), *args[1:]))
    return model
