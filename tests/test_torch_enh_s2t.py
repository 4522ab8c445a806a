"""The joint enhancement + ASR model against the JAX package, on the CPU:
the JAX test's small model (an RNN separator, a one-block transformer ASR
branch) with the same weights, its loss with and without the supervised
enhancement branch and every gradient against jax.grad, the beam search
on the composed encode, the training entry point, and the joint model
filled from the two committed assets.

Inputs are made with numpy from a seed and fed to both packages. Both
compute in fp32 with sums in another order; each tolerance says why.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode.beam_search import BeamSearchConfig as JaxConfig
from espnet_tpu.decode.beam_search import batch_beam_search as jax_search
from espnet_tpu.tasks.enh import EnhS2TTask as JaxEnhS2TTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import enh_s2t_train
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batch_beam_search)
from espnet_tpu_torch.tasks.enh import EnhS2TTask
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
TOKENS = ["<blank>", "a", "b", "<space>", "<sos/eos>"]
CFG = {"token_list": TOKENS, "enh_weight": 0.2,
       "enh_conf": {"num_spk": 1, "separator": "rnn", "n_fft": 128,
                    "hop_length": 64,
                    "separator_conf": {"rnn_hidden": 16, "num_layers": 1}},
       "asr_conf": {"frontend_conf": {"n_fft": 128, "hop_length": 64,
                                      "n_mels": 20},
                    "encoder": "transformer",
                    "encoder_conf": {"output_size": 16,
                                     "attention_heads": 2,
                                     "linear_units": 32, "num_blocks": 1,
                                     "input_layer": "linear"},
                    "decoder_conf": {"attention_heads": 2,
                                     "linear_units": 32, "num_blocks": 1},
                    "ctc_weight": 0.3}}


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def small():
    """The JAX model, its weights, the port's model with them (eval mode:
    no dropout, no SpecAug) and a batch of ragged lengths."""
    rng = np.random.RandomState(0)
    batch = {"speech_mix": (0.1 * rng.randn(2, 1600)).astype(np.float32),
             "speech_mix_lengths": np.asarray([1600, 1200]),
             "text": rng.randint(1, 4, (2, 3)),
             "text_lengths": np.asarray([3, 2]),
             "speech_ref1": (0.1 * rng.randn(2, 1600)).astype(np.float32)}
    jmod = JaxEnhS2TTask.build_model(CFG)
    flat, tree = flax_params(jmod, **{k: jnp.asarray(v) for k, v in
                                      batch.items()
                                      if k != "speech_ref1"}, seed=2)
    model = convert.load_flax_params(EnhS2TTask.build_model(CFG),
                                     flat).eval()
    return jmod, tree, model, batch


@pytest.mark.parametrize("with_ref", [False, True])
def test_loss_and_every_gradient_match_jax(small, with_ref,
                                           record_property):
    # the loss 1e-5 relative; each gradient within 1e-4 of its own
    # largest entry (fp32 backward sums in another order) plus 1e-7: the
    # attention key biases' gradients are zero by the softmax's shift
    # invariance, and so fp32 noise in both
    jmod, tree, model, batch = small
    b = {k: v for k, v in batch.items() if with_ref or k != "speech_ref1"}
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        loss, stats, _ = jmod.apply(p, **jb)
        return loss, stats

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree)
    model.zero_grad()
    loss, stats, weight = model(**{k: _t(v) for k, v in b.items()})
    loss.backward()
    assert set(stats) == set(jstats) and weight == 2.0
    for k in jstats:
        assert abs(stats[k].item() - float(jstats[k])) <= \
            1e-5 * abs(float(jstats[k])), k
    assert ("enh_loss" in stats) == with_ref
    jflat = convert.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = convert.state_dict_to_flax(model, grad=True)
    assert set(grads) == set(jflat)
    for k, ref in jflat.items():
        np.testing.assert_allclose(grads[k], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-7,
                                   err_msg=k)
    worst = max(_rel(grads[k], ref) for k, ref in jflat.items()
                if np.abs(ref).max() > 1e-6)
    record_property(f"grad_rel_err:ref_{with_ref}", worst)


def test_encode_and_beam_search_match_jax(small, record_property):
    # the encoder output within 1e-5 of its largest entry; the beam
    # search's ids equal
    jmod, tree, model, batch = small
    x, n = batch["speech_mix"], batch["speech_mix_lengths"]
    jenc, jlens = jax.jit(lambda p, a, b: jmod.apply(
        p, a, b, method=jmod.encode))(tree, jnp.asarray(x), jnp.asarray(n))
    with torch.no_grad():
        enc, lens = model.encode(_t(x), _t(n))
    assert lens.tolist() == np.asarray(jlens).tolist()
    err = _rel(enc.numpy(), jenc)
    record_property("rel_err:encode", err)
    assert err <= 1e-5
    conf = dict(beam_size=2, ctc_weight=0.3, maxlenratio=0.4)
    want = jax_search(jmod, tree, jenc, jlens, JaxConfig(**conf))
    with torch.no_grad():
        got = batch_beam_search(model, enc, lens, BeamSearchConfig(**conf))
    assert [[ids for ids, _ in h] for h in got] == \
        [[list(ids) for ids, _ in h] for h in want]


def test_enh_s2t_train_entry_point(tmp_path):
    # two steps on the CPU from a data dir of mixtures, transcripts and
    # clean references: finite, unskipped, with the enhancement loss
    corpus = SynthSpeechCorpus()
    d = tmp_path / "data"
    (d / "wav").mkdir(parents=True)
    from espnet_tpu_torch.data.fileio import write_wav
    rng = np.random.RandomState(4)
    with open(d / "wav.scp", "w") as fm, open(d / "ref.scp", "w") as fr, \
            open(d / "text", "w") as ft:
        for i in range(4):
            wave, text, _ = corpus.utterance("train", i)
            wave = wave[:4000]
            mix = wave + (0.05 * rng.randn(len(wave))).astype(np.float32)
            for tag, w, f in (("mix", mix, fm), ("ref", wave, fr)):
                write_wav(d / "wav" / f"u{i}_{tag}.wav", 16000, w)
                f.write(f"u{i} {d / 'wav' / f'u{i}_{tag}.wav'}\n")
            ft.write(f"u{i} {'a b'[:1 + i % 3]}\n")
    cfg = dict(CFG, output_dir=str(tmp_path / "exp"), device="cpu",
               batch_type="sorted", batch_size=2, max_epoch=1,
               log_interval=1, valid_data_path_and_name_and_type=[],
               train_data_path_and_name_and_type=[
                   f"{d}/wav.scp,speech_mix,sound", f"{d}/text,text,text",
                   f"{d}/ref.scp,speech_ref1,sound"])
    dump_yaml(cfg, tmp_path / "train.yaml")
    _, trainer = enh_s2t_train.main(["--config", str(tmp_path / "train.yaml")])
    steps = trainer.step_stats
    assert len(steps) == 2
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["enh_loss"])
               and not s["skipped"] for s in steps)
    assert set(load_checkpoint(tmp_path / "exp" / "checkpoint")[0]) == \
        set(convert.state_dict_to_flax(trainer.model))


def test_joint_model_from_the_two_assets():
    # params/enh from the TCN asset, params/s2t from the flagship: every
    # weight lands, and the model gives them back
    enh, asr = ROOT / "assets" / "synth_enh_tcn", \
        ROOT / "assets" / "synth_asr_flagship"
    cfg = EnhS2TTask.config_from_assets(enh, asr)
    flat = EnhS2TTask.weights_from_assets(enh, asr)
    model = convert.load_flax_params(EnhS2TTask.build_model(cfg), flat)
    assert model.enh.num_spk == 2 and model.ctc_weight == 0.3
    assert model.s2t.normalize is not None
    n_enh = len(load_checkpoint(enh)[0])
    n_asr = len(load_checkpoint(asr)[0])
    back = convert.state_dict_to_flax(model)
    assert len(back) == len(flat) == n_enh + n_asr
    assert all(np.array_equal(back[k], v) for k, v in flat.items())
    with pytest.raises(KeyError, match="missing"):
        convert.load_flax_params(EnhS2TTask.build_model(cfg),
                                 {k: v for k, v in flat.items()
                                  if not k.startswith("params/enh/")})


def test_grad_pin_takes_the_noted_estimates_and_the_tcn_kinks(small):
    # tools/grad_pin.py on a joint model: a leg whose input differs by
    # ~1e-6 reads the noting leg's separated estimates (the values, with
    # an identity gradient) and records the move; relu_inputs names the
    # TCN's kinks
    from espnet_tpu_torch.models.enh.separators import TCNSeparator
    from espnet_tpu_torch.tools import grad_pin
    _, _, model, batch = small
    x = _t(batch["speech_mix"])
    n = _t(batch["speech_mix_lengths"])
    store, moved = {}, {}
    hooks = grad_pin.pin_estimates(model, store)
    with torch.no_grad():
        noted, _, _ = model.enh.forward_enhance(x, n)
    for h in hooks:
        h.remove()
    hooks = grad_pin.pin_estimates(model, store, moved)
    xp = (x * (1 + 1e-6)).requires_grad_()
    ests, _, _ = model.enh.forward_enhance(xp, n)
    for h in hooks:
        h.remove()
    assert all(torch.equal(a, b) for a, b in zip(ests, noted))
    assert moved["enh.estimates"][2] <= grad_pin.MOVE_TOL
    ests[0].sum().backward()
    with torch.no_grad():
        assert xp.grad is not None and bool(xp.grad.abs().sum() > 0)
    assert model.enh.forward_enhance.__func__ is \
        type(model.enh).forward_enhance
    tcn = TCNSeparator(input_dim=9, layers=2, stacks=1, bottleneck_dim=4,
                       hidden_dim=6)
    assert sorted(grad_pin.relu_inputs(tcn)) == [
        ".mask_out", ".tcn0_1", "tcn0_0.conv1x1", "tcn0_0.dconv",
        "tcn0_1.conv1x1", "tcn0_1.dconv"]
