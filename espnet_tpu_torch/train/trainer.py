"""Training runtime: the train step and the epoch loop (counterpart of
espnet_tpu/train/trainer.py).

One train step is forward, loss, backward, global gradient norm, clip
and optimizer update; a step whose gradient norm is not finite leaves
the parameters and the optimizer state as they were (``optim.py``). The
epoch loop trains, validates, writes the ``checkpoint`` directory and
the ``{n}epoch`` snapshot, keeps the best and n-best epochs by
``best_model_criterion``, stops after ``patience`` epochs without
improvement, averages the n best at the end, and resumes from
``checkpoint``. A task may give two hooks: ``batch_extras_fn(epoch)`` ->
{name: array} merged into every train batch of the epoch (the speaker
task's margin warm-up), and ``extra_valid_fn(model, epoch)`` -> stats
registered in the valid epoch with weight 1 (its trial EER).

Each epoch seeds torch's generators (dropout) and the SpecAug generator
with seed + epoch, as the reference does, so a resumed run draws what an
uninterrupted one would. Steps run one at a time (the JAX package's
``steps_per_dispatch`` grouping is not needed here). Not ported (the task
refuses them): mesh/FSDP, bf16 ``train_dtype``, attention plots, the
forward/backward time breakdown and anomaly location.
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from espnet_tpu_torch import convert
from espnet_tpu_torch.train.checkpoint import (average_checkpoints,
                                               load_checkpoint,
                                               save_checkpoint)
from espnet_tpu_torch.train.reporter import Reporter

logger = logging.getLogger(__name__)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Collated numpy arrays -> tensors: floats as float32, ints as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        t = t.float() if t.is_floating_point() else t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Stats as Python floats, read from the device in one transfer."""
    keys = list(stats)
    values = torch.stack([stats[k].detach().float().reshape(())
                          for k in keys])
    return dict(zip(keys, values.tolist()))


def make_train_step(model: torch.nn.Module, optimizer) -> Callable:
    """step(batch, generator) -> (stats as floats, weight)."""

    def step(batch, generator=None):
        model.train()
        optimizer.zero_grad()
        loss, stats, weight = model(**batch, generator=generator)
        loss.backward()
        return _floats(dict(stats, **optimizer.step())), weight

    return step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """step(batch) -> (stats as floats, weight), without gradients."""

    @torch.no_grad()
    def step(batch):
        model.eval()
        _, stats, weight = model(**batch)
        return _floats(stats), weight

    return step


def evaluate(model: torch.nn.Module, iter_factory, device,
             epoch: int = 0, make_step=make_eval_step) -> Dict[str, float]:
    """Weighted means of the eval stats (of ``make_step(model)``'s step)
    over one pass of iter_factory."""
    step = make_step(model)
    sub = Reporter().start_epoch("valid", epoch)
    for _, batch in iter_factory.build_iter(epoch, shuffle=False):
        sub.register(*step(to_device(batch, device)))
    return sub.means()


class Trainer:
    def __init__(self,
                 model: torch.nn.Module,
                 optimizer,
                 output_dir,
                 train_iter_factory,
                 valid_iter_factory=None,
                 max_epoch: int = 10,
                 patience: Optional[int] = None,
                 keep_nbest_models: int = 3,
                 best_model_criterion=("valid", "loss", "min"),
                 seed: int = 0,
                 log_interval: int = 50,
                 resume: bool = False,
                 device="cuda",
                 batch_extras_fn: Optional[Callable] = None,
                 extra_valid_fn: Optional[Callable] = None):
        self.model = model
        self.optimizer = optimizer
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.train_iter_factory = train_iter_factory
        self.valid_iter_factory = valid_iter_factory
        self.max_epoch = max_epoch
        self.patience = patience
        self.keep_nbest = keep_nbest_models
        self.criterion = tuple(best_model_criterion)
        self.seed = seed
        self.log_interval = log_interval
        self.device = torch.device(device)
        self.batch_extras_fn = batch_extras_fn
        self.extra_valid_fn = extra_valid_fn
        self.reporter = Reporter()
        self.start_epoch = 1
        self._global_step = 0
        # every train step's stats of this run, in order
        self.step_stats = []
        self._train_step = make_train_step(model, optimizer)
        self._eval_step = make_eval_step(model)
        if resume and (self.output_dir / "checkpoint").exists():
            self._resume()

    def _resume(self):
        flat, opt_state, meta = load_checkpoint(
            self.output_dir / "checkpoint", with_opt=True,
            map_location=self.device)
        convert.load_flax_params(self.model, flat)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self.reporter.load_state_dict(meta["reporter"])
        self.start_epoch = meta["epoch"] + 1
        logger.info("resumed from epoch %d", meta["epoch"])

    def train_one_epoch(self, epoch: int):
        sub = self.reporter.start_epoch("train", epoch)
        torch.manual_seed(self.seed + epoch)
        generator = torch.Generator(self.device).manual_seed(
            self.seed + epoch)
        n_steps = n_skipped = 0
        extras = (self.batch_extras_fn(epoch)
                  if self.batch_extras_fn is not None else None)
        t_iter = time.perf_counter()
        for _, batch in self.train_iter_factory.build_iter(epoch):
            iter_time = time.perf_counter() - t_iter
            if extras:
                batch = {**batch, **extras}
            t0 = time.perf_counter()
            stats, weight = self._train_step(to_device(batch, self.device),
                                             generator)
            stats["train_time"] = time.perf_counter() - t0
            stats["iter_time"] = iter_time
            sub.register(stats, weight)
            self.step_stats.append(dict(stats, epoch=epoch))
            n_steps += 1
            n_skipped += int(stats["skipped"])
            self._global_step += 1
            if self._global_step % self.log_interval == 0:
                logger.info(sub.log_message())
            t_iter = time.perf_counter()
        self.reporter.finish_epoch(sub)
        if n_steps > 0 and n_skipped == n_steps:
            raise RuntimeError(
                f"all {n_steps} training steps of epoch {epoch} were "
                f"skipped (non-finite gradients); aborting")

    def validate_one_epoch(self, epoch: int):
        if self.valid_iter_factory is None:
            return
        sub = self.reporter.start_epoch("valid", epoch)
        for _, batch in self.valid_iter_factory.build_iter(epoch,
                                                           shuffle=False):
            sub.register(*self._eval_step(to_device(batch, self.device)))
        if self.extra_valid_fn is not None:
            extra = self.extra_valid_fn(self.model, epoch)
            if extra:
                sub.register(extra, 1.0)
        self.reporter.finish_epoch(sub)

    def run(self):
        """Train up to max_epoch; -> the flat flax parameters of the n-best
        average, or of the model as it ends when nothing was validated."""
        phase, key, mode = self.criterion
        best_val = None
        bad_epochs = 0
        for epoch in range(self.start_epoch, self.max_epoch + 1):
            self.reporter.set_epoch(epoch)
            self.train_one_epoch(epoch)
            self.validate_one_epoch(epoch)
            save_checkpoint(self.output_dir / f"{epoch}epoch", self.model)
            save_checkpoint(self.output_dir / "checkpoint", self.model,
                            self.optimizer,
                            meta={"epoch": epoch,
                                  "reporter": self.reporter.state_dict()})
            if self.reporter.has(phase, key, epoch):
                val = self.reporter.get_value(phase, key, epoch)
                if (best_val is None or (mode == "min" and val < best_val)
                        or (mode == "max" and val > best_val)):
                    best_val = val
                    bad_epochs = 0
                    save_checkpoint(self.output_dir / f"{phase}.{key}.best",
                                    self.model)
                else:
                    bad_epochs += 1
            self._prune_checkpoints(phase, key, mode)
            if self.patience is not None and bad_epochs > self.patience:
                logger.info("early stopping at epoch %d", epoch)
                break
        best_e, _ = self.reporter.best_epoch(phase, key, mode)
        if best_e >= 0:
            summary = {"best_epoch": best_e,
                       "criterion": f"{phase}/{key}/{mode}"}
            summary.update(self.reporter.stats[best_e][phase])
            (self.output_dir / "reporter.json").write_text(
                json.dumps(summary))
        nbest = self.reporter.sort_epochs(phase, key, mode)[:self.keep_nbest]
        paths = [self.output_dir / f"{e}epoch" for e in nbest
                 if (self.output_dir / f"{e}epoch").exists()]
        if paths:
            return average_checkpoints(
                paths,
                self.output_dir / f"{phase}.{key}.ave_{len(paths)}best")
        return convert.state_dict_to_flax(self.model)

    def _prune_checkpoints(self, phase, key, mode):
        keep = set(self.reporter.sort_epochs(phase, key,
                                             mode)[:self.keep_nbest])
        for p in self.output_dir.glob("*epoch"):
            try:
                e = int(p.name.replace("epoch", ""))
            except ValueError:
                continue
            if e not in keep and e != self.reporter.epoch:
                shutil.rmtree(p, ignore_errors=True)
