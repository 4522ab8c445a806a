"""The GAN training runtime (counterpart of
espnet_tpu/train/gan_trainer.py): a train step of two turns with two
optimizers, its valid step, and the Trainer that runs them.

A step draws once (``model.draw``: VITS's posterior noise and window
starts; nothing for the vocoder) and notes the device's random state;
each turn starts from that state, so both turns take the same draws and
the same dropout masks. In ``generator_first`` order the generator's
turn runs first: the model's forward with ``forward_generator=True``,
its backward into the generator's parameters (the discriminator's take
none), the generator's optimizer; then the discriminator's turn runs the
generator again, with the parameters just updated, and steps the
discriminator's optimizer. A turn whose gradient norm is not finite
changes nothing, not even its optimizer's state (train/optim.py); the
discriminator's turn is also skipped when a coin drawn with
``skip_discriminator_prob`` says so. The stats are both turns', with
``grad_norm_g``, ``grad_norm_d``, ``skipped`` (the generator's turn) and
``skipped_d``.

The valid step runs both turns without updates, in eval mode (no
dropout, as upstream ESPnet validates; the JAX valid step keeps dropout
on under a fixed key), on draws from a generator seeded 0 for every
batch; its ``loss`` is ``generator_loss``, which picks the best epochs.
Checkpoints hold both optimizers' states, under "generator" and
"discriminator".
"""

from __future__ import annotations

from typing import Callable

import torch

from espnet_tpu_torch.train.trainer import Trainer, _floats

EVAL_SEED = 0


class GANOptimizers:
    """The generator's and the discriminator's optimizers as one state."""

    def __init__(self, generator, discriminator):
        self.generator, self.discriminator = generator, discriminator

    def state_dict(self) -> dict:
        return {"generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict()}

    def load_state_dict(self, state: dict):
        self.generator.load_state_dict(state["generator"])
        self.discriminator.load_state_dict(state["discriminator"])


def _rng_state(device: torch.device):
    return (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(state, device: torch.device):
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def make_gan_train_step(model: torch.nn.Module, optimizers: GANOptimizers,
                        generator_first: bool = True,
                        skip_discriminator_prob: float = 0.0) -> Callable:
    """step(batch, generator, draws=None) -> (stats as floats, weight);
    ``draws`` replaces the model's own draw from ``generator``."""

    def turn(batch, draws, gen_turn: bool, skip: bool):
        opt = optimizers.generator if gen_turn else optimizers.discriminator
        opt.zero_grad()
        loss, stats, weight = model(**batch, **draws,
                                    forward_generator=gen_turn)
        loss.backward()
        return stats, weight, opt.step(skip=skip)

    def step(batch, generator=None, draws=None):
        model.train()
        device = next(iter(batch.values())).device
        if draws is None:
            draws = model.draw(batch, generator)
        skip_d = (skip_discriminator_prob > 0 and bool(
            torch.rand((), generator=generator, device=device)
            < skip_discriminator_prob))
        state = _rng_state(device)
        out = {}
        for gen_turn in ((True, False) if generator_first
                         else (False, True)):
            _set_rng_state(state, device)
            out[gen_turn] = turn(batch, draws, gen_turn,
                                 skip_d and not gen_turn)
        (gstats, weight, g_opt), (dstats, _, d_opt) = out[True], out[False]
        return _floats({**gstats, **dstats,
                        "grad_norm_g": g_opt["grad_norm"],
                        "grad_norm_d": d_opt["grad_norm"],
                        "skipped": g_opt["skipped"],
                        "skipped_d": d_opt["skipped"]}), weight

    return step


def make_gan_eval_step(model: torch.nn.Module) -> Callable:
    """step(batch) -> (both turns' stats as floats, with loss =
    generator_loss, weight), without gradients."""

    @torch.no_grad()
    def step(batch):
        model.eval()
        device = next(iter(batch.values())).device
        draws = model.draw(batch, torch.Generator(device).manual_seed(
            EVAL_SEED))
        _, gstats, weight = model(**batch, **draws, forward_generator=True)
        _, dstats, _ = model(**batch, **draws, forward_generator=False)
        stats = {**gstats, **dstats}
        stats.setdefault("loss", stats["generator_loss"])
        return _floats(stats), weight

    return step


class GANTrainer(Trainer):
    """Trainer with the GAN step; ``optimizer`` is a GANOptimizers."""

    def __init__(self, model, optimizer: GANOptimizers, *args,
                 generator_first: bool = True,
                 skip_discriminator_prob: float = 0.0, **kwargs):
        super().__init__(model, optimizer, *args, **kwargs)
        self._train_step = make_gan_train_step(
            model, optimizer, generator_first, skip_discriminator_prob)
        self._eval_step = make_gan_eval_step(model)
