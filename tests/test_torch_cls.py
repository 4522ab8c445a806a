"""The port's audio classification, language ID and anti-spoofing
against the JAX package, on the CPU: ``ClassificationModel`` with the
Transformer ``conv2d`` encoder, single-label and multi-label, its loss,
accuracy and every gradient; the ``cls1`` recipe's model at full width
on two utterances; ``ClassifySpeech`` and the CLI's ``prediction`` and
``score`` files; the LID and ASVspoof tasks' defaults and entry points;
``cls_train`` with a resume; and entry points that need a card or
``device='cpu'``.

Small models fill the JAX tree from a numpy seed
(``tests/torch_streaming_models.py:flax_params``). Logits and
probabilities are held to 1e-5 of their largest entry, losses and
gradients to 1e-4 of the largest entry (fp32 in another order), the
full-width logits to 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from espnet_tpu.bin.cls_inference import ClassifySpeech as JaxClassifySpeech
from espnet_tpu.bin.cls_inference import main as jax_cls_main
from espnet_tpu.models.cls import ClassificationModel as JaxCls
from espnet_tpu.tasks.misc import ASVSpoofTask as JaxASVSpoofTask
from espnet_tpu.tasks.spk import ClassificationTask as JaxClsTask
from espnet_tpu.tasks.spk import LIDTask as JaxLIDTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import (asvspoof_inference, asvspoof_train,
                                  cls_inference, cls_train, lid_inference,
                                  lid_train)
from espnet_tpu_torch.data.fileio import write_wav
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.models.cls import ClassificationModel
from espnet_tpu_torch.tasks.misc import ASVSpoofTask
from espnet_tpu_torch.tasks.spk import ClassificationTask, LIDTask
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

REL = 1e-5
GRAD_REL = 1e-4
FRONT = {"n_fft": 128, "hop_length": 64, "n_mels": 16, "fs": 8000}
ENC = {"output_size": 16, "attention_heads": 2, "linear_units": 24,
       "num_blocks": 2, "input_layer": "conv2d"}
# egs/synth_asr/cls1/run.py's model
RECIPE = {"n_classes": 30,
          "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
          "encoder": "transformer",
          "encoder_conf": {"output_size": 144, "attention_heads": 4,
                           "linear_units": 576, "num_blocks": 4,
                           "input_layer": "conv2d"}}


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), err


def _batch(seed, n_classes, multilabel):
    rng = np.random.RandomState(seed)
    speech = (0.3 * rng.randn(3, 4000)).astype(np.float32)
    lens = np.asarray([4000, 3100, 2000])
    speech[1, 3100:] = speech[2, 2000:] = 0.0
    if multilabel:
        label = (rng.rand(3, n_classes) > 0.5).astype(np.int64)
    else:
        label = rng.randint(0, n_classes, (3, 1))
    return speech, lens, label


@pytest.mark.parametrize("multilabel", [False, True])
def test_loss_accuracy_and_every_gradient(multilabel):
    kw = dict(n_classes=5, frontend_conf=FRONT, encoder="transformer",
              encoder_conf=ENC, multilabel=multilabel)
    jmodel = JaxCls(**kw)
    speech, lens, label = _batch(1, 5, multilabel)
    args = (jnp.asarray(speech), jnp.asarray(lens), jnp.asarray(label))
    flat, tree = flax_params(jmodel, *args, seed=2)

    def loss_fn(p):
        (loss, stats, _), seen = jmodel.apply(
            p, *args, deterministic=True,
            capture_intermediates=lambda m, _: m.name == "classifier")
        return loss, (stats,
                      seen["intermediates"]["classifier"]["__call__"][0])

    (jloss, (jstats, jlogits)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree)
    model = convert.load_flax_params(ClassificationModel(**kw), flat).eval()
    t = [torch.from_numpy(x) for x in (speech, lens, label)]
    loss, stats, weight = model(*t)
    loss.backward()
    assert weight == 3.0
    with torch.no_grad():
        _close(model.predict(*t[:2]).numpy(), jlogits, REL)
    _close(float(loss.detach()), float(jloss), GRAD_REL)
    assert float(stats["acc"]) == pytest.approx(float(jstats["acc"]),
                                                abs=1e-6)
    grads = convert.state_dict_to_flax(model, grad=True)
    jflat = {"params/" + "/".join(k): np.asarray(v)
             for k, v in flatten_dict(jgrads["params"]).items()}
    assert sorted(grads) == sorted(jflat)
    top = max(float(np.abs(g).max()) for g in jflat.values())
    for name, g in jflat.items():
        err = float(np.abs(grads[name] - g).max())
        assert err <= GRAD_REL * top, (name, err, top)


def test_recipe_model_at_full_width():
    """The cls1 recipe's model (4 blocks, d=144) on two keywords at the
    recipe's bucketed length: logits within 1e-4 of their largest; the
    frontend takes the log-mel kernel's path (its plain version here)."""
    jmodel = JaxClsTask.build_model(dict(JaxClsTask.task_defaults(),
                                         **RECIPE))
    corpus = SynthSpeechCorpus(n_words=30, min_words=1, max_words=1)
    waves = [corpus.utterance("cls-test", i)[0] for i in range(2)]
    speech = np.zeros((2, 24576), np.float32)
    lens = np.asarray([len(w) for w in waves])
    for j, w in enumerate(waves):
        speech[j, :len(w)] = w
    flat, tree = flax_params(jmodel, jnp.asarray(speech), jnp.asarray(lens),
                             jnp.zeros((2,), jnp.int32), seed=3)
    ref = jax.jit(lambda p, s, l: jmodel.apply(
        p, s, l, method=jmodel.predict))(tree, jnp.asarray(speech),
                                         jnp.asarray(lens))
    model = convert.load_flax_params(ClassificationTask.build_model(RECIPE),
                                     flat).eval()
    assert model.frontend._fused_eligible()
    with torch.no_grad():
        ours = model.predict(torch.from_numpy(speech), torch.from_numpy(lens))
    _close(ours.numpy(), ref, 1e-4)
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(flat)


def _tiny_cfg(**extra):
    return {"n_classes": 4, "frontend_conf": FRONT, "encoder": "transformer",
            "encoder_conf": ENC, **extra}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A small classifier written as the assets are."""
    d = tmp_path_factory.mktemp("cls") / "model"
    d.mkdir()
    cfg = _tiny_cfg()
    dump_yaml(cfg, d / "config.yaml")
    jmodel = JaxClsTask.build_model(cfg)
    flat, _ = flax_params(jmodel, **JaxClsTask.example_batch(cfg), seed=4)
    np.savez_compressed(d / "params_f16.npz",
                        **{k: v.astype(np.float16) for k, v in flat.items()})
    return d


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """3 train and 2 valid utterances at 8 kHz with labels."""
    root = tmp_path_factory.mktemp("cls_data")
    rng = np.random.RandomState(5)
    for split, n in (("train", 3), ("valid", 2)):
        d = root / split
        d.mkdir()
        with open(d / "wav.scp", "w") as fw, open(d / "label", "w") as fl:
            for i in range(n):
                u = f"{split}_{i}"
                write_wav(d / f"{u}.wav", 8000, (0.3 * rng.randn(
                    3000 + 500 * i)).astype(np.float32))
                fw.write(f"{u} {d / f'{u}.wav'}\n")
                fl.write(f"{u} {i % 4}\n")
    return root


def test_classify_speech_and_the_cli_match_jax(model_dir, data, tmp_path):
    cfg_path = model_dir / "config.yaml"
    c = cls_inference.ClassifySpeech(cfg_path, model_dir, device="cpu")
    jc = JaxClassifySpeech(cfg_path, model_dir)
    wav = (0.3 * np.random.RandomState(6).randn(2, 3500)).astype(np.float32)
    pred, probs = c(wav)
    jpred, jprobs = jc(wav)
    _close(probs, jprobs, REL)
    np.testing.assert_array_equal(pred, jpred)
    args = ["--data_path_and_name_and_type",
            f"{data}/valid/wav.scp,speech,sound",
            "--train_config", str(cfg_path), "--model_file", str(model_dir)]
    cls_inference.main(["--output_dir", str(tmp_path / "ours"), *args,
                        "--device", "cpu"])
    jax_cls_main(["--output_dir", str(tmp_path / "theirs"), *args])
    assert (tmp_path / "ours" / "prediction").read_text() == (
        tmp_path / "theirs" / "prediction").read_text()
    ours = dict(line.split() for line in open(tmp_path / "ours" / "score"))
    theirs = dict(line.split() for line in open(tmp_path / "theirs" /
                                                "score"))
    assert sorted(ours) == sorted(theirs) and len(ours) == 2
    for k in ours:
        assert float(ours[k]) == pytest.approx(float(theirs[k]), abs=1e-6)


@pytest.mark.parametrize("task,jax_task,infer,train", [
    (LIDTask, JaxLIDTask, lid_inference, lid_train),
    (ASVSpoofTask, JaxASVSpoofTask, asvspoof_inference, asvspoof_train)])
def test_lid_and_asvspoof_tasks(task, jax_task, infer, train, model_dir,
                                data, tmp_path):
    """Defaults as the JAX package's (ASVspoof: two classes); the
    inference entry point writes what the classification CLI writes; the
    train entry point takes a step."""
    assert task.task_defaults() == jax_task.task_defaults()
    assert ASVSpoofTask.task_defaults()["n_classes"] == 2
    args = ["--data_path_and_name_and_type",
            f"{data}/valid/wav.scp,speech,sound",
            "--train_config", str(model_dir / "config.yaml"),
            "--model_file", str(model_dir), "--device", "cpu"]
    infer.main(["--output_dir", str(tmp_path / "task"), *args])
    cls_inference.main(["--output_dir", str(tmp_path / "cls"), *args])
    for f in ("prediction", "score"):
        assert (tmp_path / "task" / f).read_text() == (
            tmp_path / "cls" / f).read_text()
    cfg = dict(_tiny_cfg(n_classes=task.task_defaults()["n_classes"]),
               output_dir=str(tmp_path / "exp"), max_epoch=1,
               batch_type="unsorted", batch_size=2, num_iters_per_epoch=1,
               device="cpu", valid_data_path_and_name_and_type=[],
               train_data_path_and_name_and_type=[
                   f"{data}/train/wav.scp,speech,sound",
                   f"{data}/train/label,label,text_int"])
    dump_yaml(cfg, tmp_path / "train.yaml")
    if task is ASVSpoofTask:       # labels of two classes
        (tmp_path / "label").write_text("".join(
            f"train_{i} {i % 2}\n" for i in range(3)))
        cfg["train_data_path_and_name_and_type"][1] = \
            f"{tmp_path}/label,label,text_int"
        dump_yaml(cfg, tmp_path / "train.yaml")
    got, trainer = train.main(["--config", str(tmp_path / "train.yaml")])
    assert got["n_classes"] == cfg["n_classes"]
    assert len(trainer.step_stats) == 1
    assert np.isfinite(trainer.step_stats[0]["loss"])


def test_entry_point_trains_checkpoints_and_resumes(model_dir, data,
                                                    tmp_path):
    """cls_train from the small model: two epochs in one run end
    bit-identical to one epoch and a resumed one."""
    def run(name, max_epoch, resume=False):
        cfg = dict(_tiny_cfg(), output_dir=str(tmp_path / name),
                   max_epoch=max_epoch, batch_type="unsorted", batch_size=2,
                   num_iters_per_epoch=1, resume=resume, device="cpu",
                   init_param=str(model_dir),
                   **{f"{s}_data_path_and_name_and_type": [
                       f"{data}/{s}/wav.scp,speech,sound",
                       f"{data}/{s}/label,label,text_int"]
                      for s in ("train", "valid")})
        dump_yaml(cfg, tmp_path / f"{name}.yaml")
        return cls_train.main(["--config", str(tmp_path / f"{name}.yaml")])

    _, trainer = run("a", 2)
    assert len(trainer.step_stats) == 2
    assert all(np.isfinite(s["loss"]) and 0 <= s["acc"] <= 1
               for s in trainer.step_stats)
    assert "acc" in trainer.reporter.stats[2]["valid"]
    run("b", 1)
    run("b", 2, resume=True)
    a = load_checkpoint(tmp_path / "a" / "checkpoint")[0]
    b = load_checkpoint(tmp_path / "b" / "checkpoint")[0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_unported_encoder_raises_and_entry_points_need_a_card(model_dir):
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        ClassificationModel(3, encoder="e_branchformer")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls_inference.ClassifySpeech(model_dir / "config.yaml", model_dir)
