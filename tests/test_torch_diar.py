"""The port's EEND diarization against the JAX package, on the CPU:
UtteranceMVN (both ``norm_vars`` branches, with and without the means),
``pit_bce_loss`` and its permutation, the EDA attractor on ragged
lengths, the model's loss, frame accuracy and every gradient (with and
without EDA), the committed asset at full width, its converter round
trip, ``DiarizeSpeech`` and the RTTM CLI, the entry point with a resume,
the recipe's ``build_dialog`` and ``frame_der``, and the ASR task's
``utterance_mvn``.

Small models fill the JAX tree from a numpy seed
(``tests/torch_streaming_models.py:flax_params``). Activations are held
to 1e-5 of their largest entry, losses and gradients to 1e-4 of the
largest entry (fp32 in another order), the asset's logits to 1e-4.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from espnet_tpu.bin.diar_inference import DiarizeSpeech as JaxDiarizeSpeech
from espnet_tpu.bin.diar_inference import main as jax_diar_main
from espnet_tpu.data.synth_speech import SynthSpeechCorpus as JaxCorpus
from espnet_tpu.frontends.default import UtteranceMVN as JaxUtteranceMVN
from espnet_tpu.models.diar import DiarizationModel as JaxDiarizationModel
from espnet_tpu.models.diar import EncoderDecoderAttractor as JaxEDA
from espnet_tpu.models.diar import pit_bce_loss as jax_pit_bce_loss
from espnet_tpu.tasks.asr import ASRTask as JaxASRTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import diar_inference, diar_train
from espnet_tpu_torch.data.synth_speech import (SynthSpeechCorpus, dialogs,
                                                materialize_dialogs)
from espnet_tpu_torch.frontends.default import UtteranceMVN
from espnet_tpu_torch.models.diar import (DiarizationModel,
                                          EncoderDecoderAttractor,
                                          pit_bce_loss)
from espnet_tpu_torch.tasks.asr import build_model as build_asr_model
from espnet_tpu_torch.tasks.spk import DiarizationTask
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
DIAR = ROOT / "assets" / "synth_diar"
REL = 1e-5
GRAD_REL = 1e-4
FRONT = {"n_fft": 64, "hop_length": 16, "n_mels": 8, "fs": 8000}
ENC = {"output_size": 16, "attention_heads": 2, "linear_units": 24,
       "num_blocks": 2, "input_layer": "conv2d"}
S = 1024


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


def _recipe():
    spec = importlib.util.spec_from_file_location(
        "diar1_recipe", ROOT / "egs" / "synth_asr" / "diar1" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("norm_means,norm_vars", [
    (True, False), (True, True), (False, True), (False, False)])
def test_utterance_mvn_matches_jax(norm_means, norm_vars):
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(3, 20, 5)).astype(np.float32)
    lens = np.asarray([20, 13, 1])
    ref, ref_lens = JaxUtteranceMVN(norm_means, norm_vars)(
        jnp.asarray(x), jnp.asarray(lens))
    ours, ours_lens = UtteranceMVN(norm_means, norm_vars)(
        torch.from_numpy(x), torch.from_numpy(lens))
    _close(ours.numpy(), ref, REL)
    np.testing.assert_array_equal(ours_lens.numpy(), np.asarray(ref_lens))


def test_pit_bce_loss_and_its_permutation():
    rng = np.random.RandomState(1)
    B, T, S_ = 4, 30, 3
    labels = (rng.rand(B, T, S_) > 0.5).astype(np.float32)
    logits = rng.randn(B, T, S_).astype(np.float32)
    # rows 0 and 1 made to predict their labels under a known permutation
    for b, perm in ((0, [2, 0, 1]), (1, [1, 2, 0])):
        inv = np.argsort(perm)
        logits[b] = (4.0 * (2 * labels[b] - 1))[:, inv] + 0.1 * logits[b]
    valid = np.arange(T)[None] < np.asarray([30, 21, 5, 0])[:, None]
    ref_loss, ref_best = jax_pit_bce_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid))
    loss, best = pit_bce_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.from_numpy(valid))
    _close(loss.numpy(), ref_loss, REL)
    np.testing.assert_array_equal(best.numpy(), np.asarray(ref_best))
    perms = [list(p) for p in __import__("itertools").permutations(range(3))]
    assert [perms[i] for i in best[:2].tolist()] == [[2, 0, 1], [1, 2, 0]]


class _WithCount:
    """``init`` with the attractor count fixed (eval_shape would trace
    it)."""

    def __init__(self, module, n):
        self.module, self.n = module, n

    def init(self, rng, *args):
        return self.module.init(rng, *args, self.n)


def test_eda_on_ragged_lengths():
    jeda = JaxEDA(unit=8)
    emb = np.random.RandomState(2).randn(3, 7, 8).astype(np.float32)
    lens = np.asarray([7, 4, 1])
    flat, tree = flax_params(_WithCount(jeda, 3), jnp.asarray(emb),
                             jnp.asarray(lens))
    ref_att, ref_ex = jax.jit(lambda p, e, l: jeda.apply(p, e, l, 3))(
        tree, jnp.asarray(emb), jnp.asarray(lens))
    eda = convert.load_flax_params(EncoderDecoderAttractor(8, unit=8), flat)
    with torch.no_grad():
        att, ex = eda(torch.from_numpy(emb), torch.from_numpy(lens), 3)
    _close(att.numpy(), ref_att, REL)
    _close(ex.numpy(), ref_ex, REL)
    # each row's carry is the one at its own length: a longer padded tail
    # changes nothing
    padded = np.concatenate([emb, np.ones((3, 5, 8), np.float32)], axis=1)
    with torch.no_grad():
        att2, _ = eda(torch.from_numpy(padded), torch.from_numpy(lens), 3)
    np.testing.assert_array_equal(att2.numpy(), att.numpy())
    back = convert.state_dict_to_flax(eda)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def _batch(seed):
    rng = np.random.RandomState(seed)
    speech = (0.3 * rng.randn(2, S)).astype(np.float32)
    lens = np.asarray([S, 700])
    speech[1, 700:] = 0.0
    labels = (rng.rand(2, 20, 2) > 0.5).astype(np.int32)
    return speech, lens, labels


@pytest.mark.parametrize("use_attractor", [False, True])
def test_loss_frame_acc_and_every_gradient(use_attractor):
    kw = dict(num_spk=2, frontend_conf=FRONT, encoder_conf=ENC,
              use_attractor=use_attractor)
    jmodel = JaxDiarizationModel(**kw)
    speech, lens, labels = _batch(3)
    args = (jnp.asarray(speech), jnp.asarray(lens), jnp.asarray(labels))
    flat, tree = flax_params(jmodel, *args, seed=4)

    def loss_fn(p):
        loss, stats, _ = jmodel.apply(p, *args, deterministic=True)
        return loss, stats

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree)
    model = convert.load_flax_params(DiarizationModel(**kw), flat).eval()
    loss, stats, weight = model(torch.from_numpy(speech),
                                torch.from_numpy(lens),
                                torch.from_numpy(labels))
    loss.backward()
    assert weight == 2.0
    _close(float(loss.detach()), float(jloss), GRAD_REL)
    assert float(stats["frame_acc"]) == pytest.approx(
        float(jstats["frame_acc"]), abs=1e-6)
    grads = convert.state_dict_to_flax(model, grad=True)
    jflat = {"params/" + "/".join(k): np.asarray(v)
             for k, v in flatten_dict(jgrads["params"]).items()}
    assert sorted(grads) == sorted(jflat)
    top = max(float(np.abs(g).max()) for g in jflat.values())
    for name, g in jflat.items():
        err = float(np.abs(grads[name] - g).max())
        assert err <= GRAD_REL * top, (name, err, top)


@pytest.fixture(scope="module")
def asset():
    from espnet_tpu.tasks.spk import DiarizationTask as JaxDiarizationTask
    jmodel, params, _ = JaxDiarizationTask.build_model_from_file(
        DIAR / "config.yaml", DIAR)
    model, cfg = DiarizationTask.build_model_from_file(
        DIAR / "config.yaml", DIAR, "cpu")
    return jmodel, params, model, cfg


def test_asset_at_full_width(asset):
    """Two 8 s dialogs through the asset: logits within 1e-4 of their
    largest, the same decisions away from 0.5."""
    jmodel, params, model, _ = asset
    waves, _ = dialogs("test", 2, 16)
    w = np.stack(waves)
    lens = np.full((2,), w.shape[1])
    ref, ref_lens = jax.jit(lambda p, s, l: jmodel.apply(
        p, s, l, method=jmodel.predict))(params, jnp.asarray(w),
                                         jnp.asarray(lens))
    with torch.no_grad():
        ours, olens = model.predict(torch.from_numpy(w),
                                    torch.from_numpy(lens))
    assert ours.shape == (2, 249, 2)
    np.testing.assert_array_equal(olens.numpy(), np.asarray(ref_lens))
    _close(ours.numpy(), ref, 1e-4)
    sure = np.abs(np.asarray(ref)) > 1e-3
    np.testing.assert_array_equal((ours.numpy() > 0)[sure],
                                  (np.asarray(ref) > 0)[sure])


def test_asset_converter_round_trip(asset):
    model = asset[2]
    flat = load_checkpoint(DIAR)[0]
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(flat) and len(flat) == 74
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_build_dialog_and_frame_der_match_the_recipe():
    recipe = _recipe()
    rng = np.random.RandomState(7)
    theirs = [recipe.build_dialog(JaxCorpus(), "test", i, rng)
              for i in range(3)]
    waves, labels = dialogs("test", 3, 7, SynthSpeechCorpus())
    for (m, lab), w, l in zip(theirs, waves, labels):
        np.testing.assert_array_equal(w, m)
        np.testing.assert_array_equal(l, lab)
    r = np.random.RandomState(8)
    for _ in range(5):
        ref = (r.rand(40, 2) > 0.4).astype(np.int32)
        hyp = (r.rand(40, 2) > 0.5).astype(np.int32)
        assert diar_inference.frame_der(ref, hyp) == recipe.frame_der(ref,
                                                                      hyp)
    assert diar_inference.frame_der(labels[0], labels[0][:, ::-1]) == 0.0


def _tiny_cfg():
    return {"num_spk": 2, "frontend_conf": FRONT, "encoder": "transformer",
            "encoder_conf": ENC}


def test_diarize_speech_and_the_cli_match_jax(tmp_path):
    """A small model written as the assets are: DiarizeSpeech's
    activities and the CLI's RTTM equal the JAX package's."""
    from espnet_tpu.tasks.spk import DiarizationTask as JaxDiarizationTask
    d = tmp_path / "model"
    d.mkdir()
    cfg = _tiny_cfg()
    dump_yaml(cfg, d / "config.yaml")
    jmodel = JaxDiarizationTask.build_model(cfg)
    flat, _ = flax_params(jmodel, **JaxDiarizationTask.example_batch(cfg),
                          seed=5)
    np.savez_compressed(d / "params_f16.npz",
                        **{k: v.astype(np.float16) for k, v in flat.items()})
    wav = (0.3 * np.random.RandomState(6).randn(2, 3000)).astype(
        np.float32)
    ours = diar_inference.DiarizeSpeech(d / "config.yaml", d,
                                        device="cpu")(wav)
    theirs = JaxDiarizeSpeech(d / "config.yaml", d)(wav)
    assert len(ours) == 2
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    from espnet_tpu_torch.data.fileio import write_wav
    scp = tmp_path / "wav.scp"
    with open(scp, "w") as f:
        for i in range(2):
            write_wav(tmp_path / f"u{i}.wav", 8000, wav[i])
            f.write(f"u{i} {tmp_path / f'u{i}.wav'}\n")
    args = ["--data_path_and_name_and_type", f"{scp},speech,sound",
            "--train_config", str(d / "config.yaml"), "--model_file",
            str(d)]
    diar_inference.main(["--output_dir", str(tmp_path / "ours"), *args,
                         "--device", "cpu"])
    jax_diar_main(["--output_dir", str(tmp_path / "theirs"), *args])
    rttm = (tmp_path / "ours" / "diarize.rttm").read_text()
    assert rttm and rttm == (tmp_path / "theirs" / "diarize.rttm"
                             ).read_text()


def test_entry_point_trains_checkpoints_and_resumes(tmp_path):
    """diar_train on npy labels: two epochs in one run end bit-identical
    to one epoch and a resumed one."""
    data = tmp_path / "data"
    for split, seed in (("train", 1), ("valid", 2)):
        materialize_dialogs(data, split, 2, seed)
    lab = np.load(next((data / "train" / "lab").glob("*.npy")))
    assert lab.shape == (250, 2) and lab.dtype == np.int32

    def run(name, max_epoch, resume=False):
        cfg = dict(_tiny_cfg(), output_dir=str(tmp_path / name),
                   max_epoch=max_epoch, batch_type="unsorted", batch_size=2,
                   num_iters_per_epoch=1, resume=resume, device="cpu",
                   collate_fixed_lengths={"speech": 128000,
                                          "spk_labels": 250},
                   train_data_path_and_name_and_type=[
                       f"{data}/train/wav.scp,speech,sound",
                       f"{data}/train/labels.scp,spk_labels,npy"],
                   valid_data_path_and_name_and_type=[
                       f"{data}/valid/wav.scp,speech,sound",
                       f"{data}/valid/labels.scp,spk_labels,npy"])
        dump_yaml(cfg, tmp_path / f"{name}.yaml")
        return diar_train.main(["--config", str(tmp_path / f"{name}.yaml")])

    _, trainer = run("a", 2)
    assert len(trainer.step_stats) == 2
    assert all(np.isfinite(s["loss"]) and 0 <= s["frame_acc"] <= 1
               for s in trainer.step_stats)
    run("b", 1)
    run("b", 2, resume=True)
    a = load_checkpoint(tmp_path / "a" / "checkpoint")[0]
    b = load_checkpoint(tmp_path / "b" / "checkpoint")[0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diar_inference.DiarizeSpeech(DIAR / "config.yaml", DIAR)


def test_asr_task_takes_utterance_mvn():
    """normalize: utterance_mvn (the ASR task's default), and global_mvn
    without a stats file, build UtteranceMVN; a tiny model's loss is the
    JAX package's."""
    cfg = {"token_list": ["<blank>", "a", "b", "c", "<sos/eos>"],
           "frontend_conf": FRONT, "normalize": "utterance_mvn",
           "encoder": "transformer", "encoder_conf": ENC,
           "decoder_conf": {"attention_heads": 2, "linear_units": 24,
                            "num_blocks": 1},
           "model_conf": {"ctc_weight": 0.3}}
    model = build_asr_model(cfg)
    assert isinstance(model.normalize, UtteranceMVN)
    fallback = build_asr_model(dict(cfg, normalize="global_mvn"))
    assert isinstance(fallback.normalize, UtteranceMVN)
    jmodel = JaxASRTask.build_model(cfg)
    flat, tree = flax_params(jmodel, **JaxASRTask.example_batch(cfg),
                             seed=9)
    convert.load_flax_params(model, flat).eval()
    speech, lens, _ = _batch(10)
    text = np.asarray([[1, 2, 3], [2, 1, 0]])
    tlens = np.asarray([3, 2])
    jloss, jstats, _ = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, deterministic=True))(tree, *map(jnp.asarray, (
            speech, lens, text, tlens)))
    with torch.no_grad():
        loss, stats, _ = model(*map(torch.from_numpy, (speech, lens, text,
                                                       tlens)))
    _close(float(loss), float(jloss), 1e-5)
    _close(float(stats["loss_ctc"]), float(jstats["loss_ctc"]), 1e-5)
