"""The port's data path, config, checkpoints and training entry point, on
the CPU: batches against the JAX package's iterator over the same data
directory, a checkpoint the port writes read by the JAX package, resume,
and ``python -m espnet_tpu_torch.bin.asr_train`` on a tiny config."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from espnet_tpu.data.fileio import read_wav as jax_read_wav
from espnet_tpu.data.synth_speech import SynthSpeechCorpus as JaxCorpus
from espnet_tpu.tasks.asr import ASRTask as JaxASRTask
from espnet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import asr_train
from espnet_tpu_torch.data.fileio import read_wav, write_wav
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.tasks.asr import ASRTask, build_model
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.train.trainer import evaluate
from espnet_tpu_torch.utils.config import dump_yaml, load_yaml
from tests.torch_streaming_models import xla_unoptimized

FLAGSHIP = (Path(__file__).resolve().parents[1] / "assets"
            / "synth_asr_flagship")


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers side by side: one torch thread
    each, or torch's pool in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    SynthSpeechCorpus().materialize(root, n_train=10, n_valid=4, n_test=0)
    return tuple([f"{root}/{split}/wav.scp,speech,sound",
                  f"{root}/{split}/text,text,text"]
                 for split in ("train", "valid"))


def test_materialized_data_dirs_equal_the_jax_package_s(tmp_path):
    SynthSpeechCorpus().materialize(tmp_path / "ours", 3, 2, 1)
    JaxCorpus().materialize(tmp_path / "ref", 3, 2, 1)
    for split in ("train", "valid", "test"):
        for name in ("wav.scp", "text"):
            ours = (tmp_path / "ours" / split / name).read_text()
            ref = (tmp_path / "ref" / split / name).read_text()
            assert ours == ref.replace(str(tmp_path / "ref"),
                                       str(tmp_path / "ours"))
        for wav in (tmp_path / "ref" / split / "wav").iterdir():
            ours = tmp_path / "ours" / split / "wav" / wav.name
            assert ours.read_bytes() == wav.read_bytes()


def tiny_cfg(datadir, out, **extra):
    train, valid = datadir
    return {
        "output_dir": str(out), "device": "cpu", "seed": 0,
        "max_epoch": 1, "num_iters_per_epoch": 2, "batch_type": "sorted",
        "batch_size": 3, "log_interval": 1,
        "optim": "adam", "optim_conf": {"lr": 0.002},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 600},
        "train_data_path_and_name_and_type": train,
        "valid_data_path_and_name_and_type": valid,
        "token_list": str(FLAGSHIP / "tokens.txt"),
        "normalize": "global_mvn",
        "stats_file": str(FLAGSHIP / "feats_stats.npz"),
        "specaug": "specaug",
        "specaug_conf": {"num_freq_mask": 2, "freq_mask_width_range": [0, 10],
                         "num_time_mask": 2, "time_mask_width_range": [0, 20]},
        "encoder": "conformer",
        "encoder_conf": {"output_size": 32, "attention_heads": 2,
                         "linear_units": 64, "num_blocks": 2,
                         "cnn_module_kernel": 7},
        "decoder": "transformer",
        "decoder_conf": {"attention_heads": 2, "linear_units": 64,
                         "num_blocks": 1},
        "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1},
        "collate_fixed_lengths": {"speech": 40000, "text": 64},
        "use_tensorboard": True, **extra}


def test_wav_write_and_read_match_the_jax_reader(tmp_path):
    wave = 0.5 * np.sin(np.arange(3001) / 7.0).astype(np.float32)
    write_wav(tmp_path / "a.wav", 16000, wave)
    rate, ours = read_wav(tmp_path / "a.wav")
    ref_rate, ref = jax_read_wav(tmp_path / "a.wav")
    assert rate == ref_rate == 16000
    np.testing.assert_array_equal(ours, ref)
    # written as round-toward-zero(x * 32767), read back as / 32768
    np.testing.assert_allclose(ours, wave, atol=2 / 32767)


def test_batches_match_the_jax_iterator(datadir, tmp_path):
    overrides = tiny_cfg(datadir, tmp_path, num_iters_per_epoch=3)
    jcfg = {**JaxASRTask.default_config(), **overrides}
    jcfg.pop("device")
    cfg = {**ASRTask.default_config(), **overrides}
    for train in (True, False):
        ref_if = JaxASRTask.build_iter_factory(jcfg, train=train)
        ours_if = ASRTask.build_iter_factory(cfg, train=train)
        for epoch in (1, 2):
            ref = list(ref_if.build_iter(epoch))
            ours = list(ours_if.build_iter(epoch))
            assert [u for u, _ in ours] == [u for u, _ in ref]
            for (_, b), (_, rb) in zip(ours, ref):
                assert sorted(b) == sorted(rb)
                for key in b:
                    assert b[key].dtype == rb[key].dtype, key
                    np.testing.assert_array_equal(b[key], rb[key])
    assert len(ours) == 2   # valid: 4 utterances in batches of 3


def test_config_is_written_and_read_back(datadir, tmp_path):
    cfg = ASRTask.default_config()
    cfg.update(tiny_cfg(datadir, tmp_path, scheduler_conf={"warmup_steps":
                                                            1e-5}))
    dump_yaml(cfg, tmp_path / "config.yaml")
    assert load_yaml(tmp_path / "config.yaml") == cfg
    with open(tmp_path / "config.yaml") as f:
        assert yaml.safe_load(f) == cfg


def test_entry_point_trains_on_the_cpu_only_when_asked(datadir, tmp_path,
                                                       monkeypatch):
    cfg = tiny_cfg(datadir, tmp_path / "exp")
    cfg.pop("device")
    dump_yaml(cfg, tmp_path / "train.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        asr_train.main(["--config", str(tmp_path / "train.yaml")])
    resolved, trainer = asr_train.main(
        ["--config", str(tmp_path / "train.yaml"), "--device", "cpu",
         "--output_dir", str(tmp_path / "exp2")])
    assert resolved["device"] == "cpu"
    assert len(trainer.step_stats) == 2
    for stats in trainer.step_stats:
        assert np.isfinite(stats["loss"]) and stats["skipped"] == 0.0
    out = tmp_path / "exp2"
    for name in ("checkpoint/params.pkl", "checkpoint/opt_state.pt",
                 "checkpoint/meta.json", "1epoch/params.pkl",
                 "valid.loss.best/params.pkl", "reporter.json",
                 "config.yaml"):
        assert (out / name).exists(), name
    assert load_yaml(out / "config.yaml") == resolved
    assert trainer.optimizer.count == 2


@pytest.mark.parametrize("option,value", [("train_dtype", "bfloat16"),
                                          ("accum_grad", 2),
                                          ("use_mesh", True),
                                          ("batch_type", "catbel")])
def test_unported_options_raise(datadir, tmp_path, option, value):
    with pytest.raises(NotImplementedError):
        ASRTask.main(tiny_cfg(datadir, tmp_path, **{option: value}))


def test_jax_package_reads_a_port_checkpoint(datadir, tmp_path,
                                             record_property):
    cfg, trainer = ASRTask.main(tiny_cfg(datadir, tmp_path))
    params, _, meta = jax_load_checkpoint(tmp_path / "checkpoint")
    assert meta["epoch"] == 1
    model = trainer.model.eval()
    _, batch = next(iter(ASRTask.build_iter_factory(cfg, False)
                         .build_iter(1, shuffle=False)))
    jmodel = JaxASRTask.build_model({**JaxASRTask.default_config(), **cfg})
    ref, _, _ = jax.jit(lambda p, b: jmodel.apply(p, **b, deterministic=True)
                        )(params, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    with torch.no_grad():
        loss, _, _ = model(**{k: torch.from_numpy(v).float()
                              if v.dtype.kind == "f"
                              else torch.from_numpy(v).long()
                              for k, v in batch.items()})
    # the same weights through the two packages in fp32
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    record_property("loss_rel_diff", abs(float(loss) / float(ref) - 1))
    # and the port reads it back into the same validation loss
    fresh = build_model(cfg)
    convert.load_flax_params(fresh, load_checkpoint(tmp_path /
                                                    "checkpoint")[0])
    valid_if = ASRTask.build_iter_factory(cfg, False)
    assert evaluate(fresh, valid_if, "cpu")["loss"] == \
        trainer.reporter.stats[1]["valid"]["loss"]


def test_resume_matches_an_uninterrupted_run(datadir, tmp_path):
    # dropout and SpecAug on: the per-epoch seeds must carry over
    whole = tmp_path / "whole"
    ASRTask.main(tiny_cfg(datadir, whole, max_epoch=2))
    split = tmp_path / "split"
    ASRTask.main(tiny_cfg(datadir, split, max_epoch=1))
    _, trainer = ASRTask.main(tiny_cfg(datadir, split, max_epoch=2,
                                       resume=True))
    assert trainer.start_epoch == 2 and len(trainer.step_stats) == 2
    ref, _, ref_meta = load_checkpoint(whole / "checkpoint")
    ours, _, meta = load_checkpoint(split / "checkpoint")
    assert meta["epoch"] == ref_meta["epoch"] == 2

    def untimed(m):   # the host-clock times differ run to run
        return {e: {ph: {k: v for k, v in st.items()
                         if k not in ("train_time", "iter_time")}
                    for ph, st in phases.items()}
                for e, phases in m["reporter"]["stats"].items()}

    assert untimed(meta) == untimed(ref_meta)
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
