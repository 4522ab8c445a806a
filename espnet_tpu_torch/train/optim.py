"""Optimizers and learning-rate schedules (counterpart of
espnet_tpu/train/optim.py).

A schedule is a function of the number of updates already applied (0 on
the first update), as an optax schedule reads its count; WarmupLR counts
its step from 1 on the first update. ``Optimizer`` composes, as the JAX
package's optax chain does: clip by global norm -> Adam/AdamW at the
scheduled rate. A step whose gradient norm is not finite changes
nothing: not the parameters, not Adam's moments or step count, not the
schedule's step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def warmup_lr(lr: float, warmup_steps: int = 25000) -> Callable[[int], float]:
    """WarmupLR: lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5), s = the
    update's number counted from 1."""

    def schedule(count: int) -> float:
        s = count + 1.0
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)

    return schedule


def build_schedule(name: Optional[str], lr: float,
                   conf: Optional[dict] = None) -> Callable[[int], float]:
    conf = dict(conf or {})
    if name is None or name == "none":
        return lambda count: lr
    if name.lower() == "warmuplr":
        return warmup_lr(lr, **conf)
    raise NotImplementedError(f"scheduler {name!r}: the port has warmuplr "
                              f"and none")


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient entry (optax's)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads, norm: torch.Tensor, max_norm: float):
    """optax's clip_by_global_norm: g * max_norm / norm where norm >=
    max_norm (torch's clip_grad_norm_ divides by norm + 1e-6 instead)."""
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


class Optimizer:
    """Clip, then Adam or AdamW with a scheduled learning rate; steps with
    a non-finite gradient norm are skipped whole."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], name: str,
                 schedule: Callable[[int], float], betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = 5.0,
                 decay_grouping: bool = True):
        name = name.lower()
        if name not in ("adam", "adamw"):
            raise NotImplementedError(f"optim {name!r}: the port has adam "
                                      f"and adamw")
        self.params = list(params.values())
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0  # updates applied: the schedule's and Adam's step
        if name == "adam" and weight_decay == 0.0:
            groups = [{"params": self.params, "weight_decay": 0.0}]
        else:
            # decoupled decay; with decay_grouping, only tensors of >= 2
            # dims decay (no biases, no LayerNorm scales), as optax's mask
            decay = [p for p in self.params
                     if p.dim() >= 2 or not decay_grouping]
            rest = [p for p in self.params
                    if p.dim() < 2 and decay_grouping]
            groups = [{"params": decay, "weight_decay": weight_decay},
                      {"params": rest, "weight_decay": 0.0}]
        self.torch_opt = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=schedule(0),
            betas=tuple(betas), eps=eps)

    def step(self, skip: bool = False) -> Dict[str, torch.Tensor]:
        """Clip and apply the gradients now in ``.grad``, unless their norm
        is not finite or ``skip`` (a GAN step's discriminator coin); ->
        {grad_norm, skipped} (the norm before clipping)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        norm = global_norm(grads)
        ok = bool(torch.isfinite(norm)) and not skip
        if ok:
            if self.grad_clip is not None and self.grad_clip > 0:
                clip_by_global_norm_(grads, norm, self.grad_clip)
            for group in self.torch_opt.param_groups:
                group["lr"] = self.schedule(self.count)
            self.torch_opt.step()
            self.count += 1
        return {"grad_norm": norm, "skipped": norm.new_tensor(float(not ok))}

    def zero_grad(self):
        self.torch_opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"count": self.count, "torch": self.torch_opt.state_dict()}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.torch_opt.load_state_dict(state["torch"])


def build_optimizer(params: Dict[str, torch.nn.Parameter], name: str = "adam",
                    lr: float = 1e-3, scheduler: Optional[str] = None,
                    scheduler_conf: Optional[dict] = None,
                    weight_decay: float = 0.0, betas=(0.9, 0.999),
                    eps: float = 1e-8, grad_clip: Optional[float] = 5.0,
                    accum_grad: int = 1,
                    decay_grouping: bool = True) -> Optimizer:
    if accum_grad > 1:
        raise NotImplementedError("accum_grad > 1 is not ported yet")
    return Optimizer(params, name, build_schedule(scheduler, lr,
                                                  scheduler_conf),
                     betas=betas, eps=eps, weight_decay=weight_decay,
                     grad_clip=grad_clip, decay_grouping=decay_grouping)

