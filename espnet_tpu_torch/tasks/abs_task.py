"""Task spine: config -> data -> model -> trainer (counterpart of
espnet_tpu/tasks/abs_task.py:AbsTask).

A task declares its defaults, ``build_model(cfg)`` and its preprocessor;
``main`` resolves the config (defaults <- ``--config`` file <- overrides
<- ``--key value`` arguments), writes it to ``output_dir/config.yaml``,
builds the iterators, initialises the model as flax would, loads
``init_param``, and trains on the card (``device`` None) or where
``device`` says.

Options the port has not ported raise NotImplementedError when they are
on: ``collect_stats``, ``train_dtype`` other than fp32, ``use_mesh`` and
``fsdp``, ``launch_conf``, ``accum_grad`` > 1 and ``detect_anomaly``.
Those that only observe a run (tensorboard, wandb, attention plots, the
time breakdown, orbax) are ignored, with a log line when they are on.
``steps_per_dispatch`` > 1 only groups K same-shape steps into one
device program in the JAX package (its trainer scans the same train step
over them): the port runs them one step at a time, with a log line.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from espnet_tpu_torch import convert
from espnet_tpu_torch.data.batching import (build_batch_sampler,
                                            common_collate_fn)
from espnet_tpu_torch.data.dataset import ESPnetDataset
from espnet_tpu_torch.data.iterator import SequenceIterFactory
from espnet_tpu_torch.nn.initialize import init_like_flax
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer
from espnet_tpu_torch.utils.config import (dump_yaml, load_yaml,
                                           resolve_config)
from espnet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

COMMON_DEFAULTS: Dict[str, Any] = {
    "output_dir": "exp/task",
    "seed": 0,
    "max_epoch": 10,
    "patience": None,
    "keep_nbest_models": 3,
    "best_model_criterion": [["valid", "loss", "min"]],
    "num_iters_per_epoch": None,
    "batch_type": "numel",
    "batch_size": 20,
    "batch_bins": 1000000,
    "sort_in_batch": "descending",
    "optim": "adam",
    "optim_conf": {"lr": 0.001},
    "scheduler": None,
    "scheduler_conf": {},
    "grad_clip": 5.0,
    "accum_grad": 1,
    "log_interval": 50,
    "train_data_path_and_name_and_type": [],
    "valid_data_path_and_name_and_type": [],
    "train_shape_file": [],
    "valid_shape_file": [],
    "collect_stats": False,
    "resume": False,
    "use_preprocessor": True,
    "init_param": None,
    "device": None,   # None: the card
}

# on in a config: refused, since the port would train something else
UNPORTED = {
    "collect_stats": lambda v: bool(v),
    "train_dtype": lambda v: v not in (None, "float32", "fp32"),
    "use_mesh": lambda v: bool(v),
    "fsdp": lambda v: bool(v),
    "launch_conf": lambda v: bool(v),
    "detect_anomaly": lambda v: bool(v),
    "batch_type": lambda v: v in ("catbel", "catpow", "catpow_balance"),
}
# on in a config: ignored, since they only observe a run
IGNORED = ("use_tensorboard", "use_wandb", "num_att_plot",
           "profile_breakdown", "use_orbax")


def parse_triples(spec) -> List[Tuple[str, str, str]]:
    """(path, name, type) triples from 'p,n,t' | ['p,n,t', ...] |
    ['p', 'n', 't'] | [['p', 'n', 't'], ...]."""
    if isinstance(spec, str):
        spec = [spec]
    spec = list(spec)
    if len(spec) == 3 and all(isinstance(s, str) and "," not in s
                              for s in spec):
        return [tuple(spec)]
    out = []
    for t in spec:
        parts = tuple(t.split(",")) if isinstance(t, str) else tuple(t)
        if len(parts) != 3:
            raise ValueError(f"bad data triple {t!r}; want path,name,type")
        out.append(parts)
    return out


def shard_keys(keys, job_id: int, num_jobs: int) -> List[str]:
    """Job ``job_id``'s contiguous share of ``keys`` out of ``num_jobs``,
    the first ``len(keys) % num_jobs`` jobs taking one more."""
    base, rem = divmod(len(keys), num_jobs)
    start = job_id * base + min(job_id, rem)
    return list(keys[start:start + base + (1 if job_id < rem else 0)])


# files that a packed model dir (the committed assets) holds beside its
# config, in place of the paths the config names
PACKED_FILES = (("token_list", "tokens.txt"),
                ("stats_file", "feats_stats.npz"))


def load_packed_config(config_file) -> Dict[str, Any]:
    """The config, with ``token_list`` and ``stats_file`` pointed at
    ``tokens.txt`` and ``feats_stats.npz`` beside it where those exist,
    as the bench does: the configured paths name a training work
    directory that may belong to another checkout. Without a local file
    the configured path stands."""
    cfg = load_yaml(config_file)
    here = Path(config_file).parent
    for key, fname in PACKED_FILES:
        if (here / fname).exists():
            cfg[key] = str(here / fname)
    return cfg


def model_from_file(build, config_file, model_file, device, overrides=None):
    """-> (``build(cfg)`` with the weights of ``model_file``, on ``device``
    in eval mode, and cfg, updated by ``overrides``). ``model_file`` is a
    checkpoint directory of the trainer, a directory holding
    ``params_f16.npz``, or an npz file; None initialises as flax would,
    from seed 0."""
    cfg = load_packed_config(config_file)
    cfg.update(overrides or {})
    model = build(cfg)
    if model_file is None:
        init_like_flax(model, torch.Generator().manual_seed(0))
    else:
        convert.load_flax_params(model, load_checkpoint(model_file)[0])
    return model.to(device).eval(), cfg


class AbsTask:
    name: str = "abs"

    # ---- to be overridden -----------------------------------------
    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {}

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]) -> torch.nn.Module:
        raise NotImplementedError

    @classmethod
    def build_preprocess_fn(cls, cfg: Dict[str, Any], train: bool):
        return None

    @classmethod
    def batch_extras_fn(cls, cfg: Dict[str, Any]):
        """Optional epoch -> {name: array} merged into every train batch
        of the epoch (a margin schedule); None: nothing."""
        return None

    @classmethod
    def build_extra_valid_fn(cls, cfg: Dict[str, Any]):
        """Optional fn(model, epoch) -> stats, registered in each valid
        epoch with weight 1 (the speaker task's trial EER); None: none."""
        return None

    # ---- shared machinery -----------------------------------------
    @classmethod
    def build_model_from_file(cls, config_file, model_file, device=None,
                              overrides=None):
        """-> (the task's model with the weights of ``model_file``, in eval
        mode on ``device`` (None: the card), and its config, updated by
        ``overrides``)."""
        return model_from_file(cls.build_model, config_file, model_file,
                               resolve_device(device), overrides)

    @classmethod
    def default_config(cls) -> Dict[str, Any]:
        return {**COMMON_DEFAULTS, **cls.task_defaults()}

    @classmethod
    def check_supported(cls, cfg: Dict[str, Any]):
        on = [k for k, is_on in UNPORTED.items() if is_on(cfg.get(k))]
        if on:
            raise NotImplementedError(f"not ported: {on}")
        ignored = [k for k in IGNORED if cfg.get(k)]
        if ignored:
            logger.info("ignored (they only observe a run): %s", ignored)
        if cfg.get("steps_per_dispatch") not in (None, 1):
            logger.info("steps_per_dispatch %s: run one step at a time (it "
                        "only groups the JAX package's steps into one "
                        "dispatch)", cfg["steps_per_dispatch"])

    @classmethod
    def build_dataset(cls, cfg, train: bool) -> ESPnetDataset:
        key = "train" if train else "valid"
        pre = (cls.build_preprocess_fn(cfg, train)
               if cfg.get("use_preprocessor", True) else None)
        return ESPnetDataset(
            parse_triples(cfg[f"{key}_data_path_and_name_and_type"]),
            preprocess=pre)

    # above this many utterances, shapes come from shape files, not from
    # reading the whole corpus once before training
    MAX_INFERRED_SHAPES = 5000

    @classmethod
    def _shapes_from_dataset(cls, ds: ESPnetDataset) -> Dict[str, int]:
        """Without shape files: each utterance's first data's length."""
        keys = ds.keys()
        if len(keys) > cls.MAX_INFERRED_SHAPES:
            raise RuntimeError(
                f"dataset has {len(keys)} utterances but no shape files "
                f"were given; pass train_shape_file/valid_shape_file")
        shapes = {}
        for k in keys:
            first = np.asarray(next(iter(ds[k][1].values())))
            shapes[k] = int(first.shape[0]) if first.ndim else 1
        return shapes

    @classmethod
    def build_iter_factory(cls, cfg, train: bool) -> SequenceIterFactory:
        ds = cls.build_dataset(cfg, train)
        key = "train" if train else "valid"
        shape_files = cfg.get(f"{key}_shape_file") or []
        batches = build_batch_sampler(
            batch_type=cfg["batch_type"] if train else "unsorted",
            batch_size=cfg["batch_size"],
            batch_bins=cfg["batch_bins"],
            shape_files=shape_files,
            utt2shapes=(None if shape_files
                        else [cls._shapes_from_dataset(ds)]),
            keys=ds.keys(),
            sort_in_batch=cfg.get("sort_in_batch", "descending"),
            fold_length=cfg.get("fold_length", 80000))
        collate = functools.partial(
            common_collate_fn,
            bucket_growth=cfg.get("collate_bucket_growth", 1.25),
            fixed_lengths=cfg.get("collate_fixed_lengths"))
        return SequenceIterFactory(
            ds, batches, collate_fn=collate, seed=cfg["seed"],
            shuffle=train,
            num_iters_per_epoch=cfg["num_iters_per_epoch"] if train else None)

    @classmethod
    def _setup_training(cls, cfg):
        """Output dir with the resolved config, and the iter factories."""
        out = Path(cfg["output_dir"])
        out.mkdir(parents=True, exist_ok=True)
        dump_yaml(cfg, out / "config.yaml")
        train_if = cls.build_iter_factory(cfg, train=True)
        has_valid = (cfg["valid_data_path_and_name_and_type"]
                     or cfg.get("valid_multi_task_dataset"))
        valid_if = (cls.build_iter_factory(cfg, train=False)
                    if has_valid else None)
        return out, train_if, valid_if

    @classmethod
    def main(cls, cfg: Optional[Dict[str, Any]] = None,
             argv: Optional[List[str]] = None):
        """Train; -> (resolved cfg, the Trainer after its run)."""
        cfg = resolve_config(cls.default_config(), overrides=cfg, argv=argv)
        logging.basicConfig(level=logging.INFO)
        cls.check_supported(cfg)
        device = resolve_device(cfg.get("device"))
        out, train_if, valid_if = cls._setup_training(cfg)
        torch.manual_seed(cfg["seed"])
        model = cls.build_model(cfg)
        init_like_flax(model, torch.Generator().manual_seed(cfg["seed"]))
        if cfg.get("init_param"):
            cls.load_pretrained(model, cfg["init_param"])
        model.to(device)
        trainer = cls.build_trainer(cfg, model, out, train_if, valid_if,
                                    device)
        trainer.run()
        return cfg, trainer

    @classmethod
    def trainer_kwargs(cls, cfg, out, train_if, valid_if, device) -> dict:
        """The Trainer's arguments after the model and the optimizer."""
        return dict(
            output_dir=out, train_iter_factory=train_if,
            valid_iter_factory=valid_if, max_epoch=cfg["max_epoch"],
            patience=cfg["patience"],
            keep_nbest_models=cfg["keep_nbest_models"],
            best_model_criterion=tuple(cfg["best_model_criterion"][0]),
            seed=cfg["seed"], log_interval=cfg["log_interval"],
            resume=cfg["resume"], device=device,
            batch_extras_fn=cls.batch_extras_fn(cfg),
            extra_valid_fn=cls.build_extra_valid_fn(cfg))

    @classmethod
    def build_trainer(cls, cfg, model, out, train_if, valid_if, device):
        optimizer = build_optimizer(
            dict(model.named_parameters()), cfg["optim"],
            scheduler=cfg["scheduler"], scheduler_conf=cfg["scheduler_conf"],
            grad_clip=cfg["grad_clip"], accum_grad=cfg["accum_grad"],
            **cfg["optim_conf"])
        return Trainer(model, optimizer, **cls.trainer_kwargs(
            cfg, out, train_if, valid_if, device))

    @classmethod
    def load_pretrained(cls, model: torch.nn.Module, init_param_specs):
        """``path[:src_key:dst_key:exclude_keys]``: take the checkpoint's
        parameters under ``src_key``, re-rooted at ``dst_key``, without
        ``exclude_keys`` (comma-separated), and set those whose flax name
        and shape match the model's. Keys are flax paths ("params/...";
        "<part>/params/..." for a model with ``flax_parts``). The arrays
        set are counted per top-level part; a spec that sets none raises,
        and so does a load that leaves a part of a model with parts (a
        GAN's generator or discriminator) without any array, unless the
        specs' ``dst_key``s name the parts they are for. The counts stay
        on the model as ``init_param_counts``."""
        if isinstance(init_param_specs, str):
            init_param_specs = [init_param_specs]
        own = convert.state_dict_to_flax(model)
        per_part: Dict[str, int] = {}
        wanted = set()
        for spec in init_param_specs:
            path, src, dst, excl = (str(spec).split(":") + ["", "", ""])[:4]
            excl = [e for e in excl.split(",") if e]
            loaded, _, _ = load_checkpoint(path)
            n_set = 0
            for name, v in loaded.items():
                if src:
                    if not (name == src or name.startswith(src + "/")):
                        continue
                    name = name[len(src):].lstrip("/")
                if dst:
                    name = f"{dst}/{name}".strip("/") if name else dst
                if any(name == e or name.startswith(e + "/") for e in excl):
                    continue
                if name in own and own[name].shape == np.shape(v):
                    own[name] = np.asarray(v, np.float32)
                    n_set += 1
                    top = name.partition("/")[0]
                    per_part[top] = per_part.get(top, 0) + 1
            if n_set == 0:
                raise ValueError(f"init_param {spec!r} matched nothing")
            logger.info("init_param %s: loaded %d tensors", spec, n_set)
            wanted.add(dst.partition("/")[0] if dst else None)
        parts = getattr(model, "flax_parts", None)
        if parts:
            need = set(parts) if None in wanted else wanted & set(parts)
            empty = sorted(p for p in need if not per_part.get(p))
            if empty:
                raise ValueError(f"init_param {init_param_specs!r} set no "
                                 f"array of {empty}; arrays set per part: "
                                 f"{per_part}")
        convert.load_flax_params(model, own)
        model.init_param_counts = per_part
        return model


class AbsGANTask(AbsTask):
    """The two-optimizer GAN task (counterpart of
    espnet_tpu/tasks/abs_task.py:AbsGANTask): AbsTask's config, data and
    checkpoints, with ``optim`` / ``optim_conf`` (and ``scheduler``) for
    the generator, ``optim2`` / ``optim2_conf`` / ``scheduler2`` for the
    discriminator, and training through GANTrainer
    (``generator_first``, ``skip_discriminator_prob``). The model has
    ``generator`` and ``discriminator`` parts (``flax_parts``), ``draw``
    and a forward with ``forward_generator``."""

    @classmethod
    def gan_defaults(cls) -> Dict[str, Any]:
        return {"optim": "adam", "optim_conf": {"lr": 2e-4,
                                                "betas": (0.5, 0.9)},
                "optim2": "adam", "optim2_conf": {"lr": 2e-4,
                                                  "betas": (0.5, 0.9)},
                "scheduler2": None, "scheduler2_conf": {},
                "generator_first": True, "skip_discriminator_prob": 0.0}

    @classmethod
    def default_config(cls) -> Dict[str, Any]:
        return {**COMMON_DEFAULTS, **cls.gan_defaults(),
                **cls.task_defaults()}

    @classmethod
    def build_trainer(cls, cfg, model, out, train_if, valid_if, device):
        from espnet_tpu_torch.train.gan_trainer import (GANOptimizers,
                                                        GANTrainer)
        opts = [build_optimizer(
            dict(getattr(model, part).named_parameters()),
            cfg[f"optim{n}"], scheduler=cfg.get(f"scheduler{n}"),
            scheduler_conf=cfg.get(f"scheduler{n}_conf") or {},
            grad_clip=cfg["grad_clip"], accum_grad=cfg["accum_grad"],
            **cfg[f"optim{n}_conf"])
            for part, n in (("generator", ""), ("discriminator", "2"))]
        return GANTrainer(
            model, GANOptimizers(*opts),
            **cls.trainer_kwargs(cfg, out, train_if, valid_if, device),
            generator_first=cfg.get("generator_first", True),
            skip_discriminator_prob=cfg.get("skip_discriminator_prob", 0.0))
