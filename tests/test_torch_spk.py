"""The port's speaker verification against the JAX package, on the CPU:
each ECAPA module and the other encoders' modules, ``aam_softmax_loss``
with a margin and its gradients against ``jax.grad``, the speaker model
with each of the four encoders (loss and every gradient, at
``tests/test_spk_depth.py``'s small sizes), the committed ECAPA asset at
full width and its converter round trip, EER and minDCF on tied scores,
the margin warm-up and the margin in the loss, the trial-EER hook's
padding, ``SpeakerEmbedding`` and the two CLIs, the recipe's trial list,
``spk_train`` with a resume, and entry points that need a card or
``device='cpu'``.

Small models fill the JAX tree from a numpy seed
(``tests/torch_streaming_models.py:flax_params``). Activations are held
to 1e-5 of their largest entry, losses and gradients to 1e-4 of the
largest entry (fp32 in another order), the asset's embeddings to 1e-4.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from espnet_tpu.bin.spk_embed_extract import extract as jax_extract
from espnet_tpu.bin.spk_inference import SpeakerEmbedding as JaxEmbedding
from espnet_tpu.bin.spk_inference import main as jax_spk_main
from espnet_tpu.data.synth_speech import SynthSpeechCorpus as JaxCorpus
from espnet_tpu.models import spk as jspk
from espnet_tpu.tasks.spk import SpeakerTask as JaxSpeakerTask
from espnet_tpu.utils import eer as jeer
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import spk_embed_extract, spk_inference, spk_train
from espnet_tpu_torch.data.batching import bucket_length
from espnet_tpu_torch.data.fileio import write_wav
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.models import spk
from espnet_tpu_torch.tasks.spk import SpeakerTask
from espnet_tpu_torch.tools import grad_pin
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils import eer
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
ECAPA = ROOT / "assets" / "synth_spk_ecapa"
REL = 1e-5
GRAD_REL = 1e-4
FRONT = {"n_fft": 256, "hop_length": 128, "n_mels": 20}
# tests/test_spk_depth.py's sizes, and a small ECAPA
ENCODERS = {
    "ecapa": {"channels": 16, "num_blocks": 2},
    "rawnet3": {"ndim": 16, "model_scale": 4, "out_channels": 24,
                "stem_filters": 16, "stem_kernel": 65},
    "ska_tdnn": {"channels": 4, "num_res_blocks": 2, "tdnn_channels": 16,
                 "num_blocks": 2},
    "xvector": {"channels": 16, "out_channels": 32},
}
# SKA-TDNN's LayerNorms over 4 channels amplify fp32 rounding: on this
# test's batch both packages' fp32 gradients lie 1.7-1.8e-3 (of the
# largest gradient) from float64. There both packages also run in float64
# from the same features (the JAX frontend's, which computes in fp32):
# the port's loss and gradients are held to JAX's at 1e-9 of the largest
# (4.5e-12 measured), and its fp32 gradients to JAX's float64 ones at
# 2.5e-3.
EMBED_REL = {"ska_tdnn": 1e-4}
FLOAT64_HELD = {"ska_tdnn": 2.5e-3}
F64_REL = 1e-9


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


def _flat_grads(jgrads):
    return {"params/" + "/".join(k): np.asarray(v)
            for k, v in flatten_dict(jgrads["params"]).items()}


def _grads_close(grads, jflat, rel=GRAD_REL):
    """Every gradient within ``rel`` of the largest JAX gradient."""
    assert sorted(grads) == sorted(jflat)
    top = max(float(np.abs(g).max()) for g in jflat.values())
    for name, g in jflat.items():
        err = float(np.abs(grads[name] - g).max())
        assert err <= rel * top, (name, err, top)


def _frames(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (JAX module, port module, JAX inputs); the port module takes the same
# inputs as torch tensors
MODULES = {
    "se_res2net_block": lambda: (jspk.SERes2NetBlock(12, dilation=2),
                                 spk.SERes2NetBlock(12, dilation=2),
                                 [_frames(0, (2, 11, 12))]),
    "ecapa_encoder": lambda: (jspk.EcapaEncoder(16, 3),
                              spk.EcapaEncoder(10, 16, 3),
                              [_frames(1, (2, 13, 10))]),
    "attn_stat_pooling": lambda: (
        jspk.AttnStatPooling(hidden=8), spk.AttnStatPooling(6, hidden=8),
        [_frames(2, (3, 9, 6)),
         np.arange(9)[None] < np.asarray([9, 4, 1])[:, None]]),
    "afms": lambda: (jspk.AFMS(), spk.AFMS(8), [_frames(3, (2, 7, 8))]),
    "bottle2neck_pooled": lambda: (
        jspk.Bottle2neck(16, scale=4, dilation=2, pool=3),
        spk.Bottle2neck(12, 16, dilation=2, scale=4, pool=3),
        [_frames(4, (2, 17, 12))]),
    "sk_attention_freq": lambda: (
        jspk.SKAttention(axis="freq"), spk.SKAttention(4, 7, axis="freq"),
        [_frames(5, (2, 6, 7, 4))]),
    "sk_attention_channel": lambda: (
        jspk.SKAttention(axis="channel"), spk.SKAttention(4, 7),
        [_frames(6, (2, 6, 7, 4))]),
    "ska_res_block": lambda: (
        jspk.SkaResBlock(4, stride=2), spk.SkaResBlock(3, 4, 9, stride=2),
        [_frames(7, (2, 5, 9, 3))]),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    jmod, mod, inputs = MODULES[name]()
    jin = [jnp.asarray(x) for x in inputs]
    flat, tree = flax_params(jmod, *jin, seed=8)
    ref = jax.jit(jmod.apply)(tree, *jin)
    convert.load_flax_params(mod, flat)
    with torch.no_grad():
        ours = mod(*[torch.from_numpy(np.asarray(x)) for x in inputs])
    _close(ours.numpy(), ref, REL)


def test_max_pool_and_stem_match_flax():
    """SAME max-pools at odd lengths (-inf padding), and RawNet3's strided
    sinc stem with flax's uneven SAME padding."""
    import flax.linen as fnn
    x = _frames(9, (2, 13, 5))
    for p in (3, 5):
        ref = fnn.max_pool(jnp.asarray(x), (p,), strides=(p,),
                           padding="SAME")
        np.testing.assert_array_equal(
            spk.max_pool_same(torch.from_numpy(x), p).numpy(), ref)
    np.testing.assert_array_equal(spk.mel_init_cutoffs(16, 16000.0),
                                  __import__(
                                      "espnet_tpu.nn.preencoder",
                                      fromlist=["_"])._mel_init_cutoffs(
                                          16, 16000.0))


@pytest.mark.parametrize("margin", [0.0, 0.3])
def test_aam_softmax_loss_and_its_gradients(margin):
    rng = np.random.RandomState(10)
    emb = rng.randn(5, 8).astype(np.float32)
    w = rng.randn(6, 8).astype(np.float32)
    w[2] = emb[0] * 3.0      # a cosine at 1, clipped before its arccos
    labels = np.asarray([2, 0, 5, 1, 1])

    def f(e, wt):
        return jspk.aam_softmax_loss(e, wt, jnp.asarray(labels), margin,
                                     30.0)

    (jloss, jacc), (je, jw) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(emb), jnp.asarray(w))
    te = torch.from_numpy(emb).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss, acc = spk.aam_softmax_loss(te, tw, torch.from_numpy(labels),
                                     torch.tensor(margin), 30.0)
    loss.backward()
    _close(float(loss.detach()), float(jloss), REL)
    assert float(acc) == float(jacc)
    _close(te.grad.numpy(), je, GRAD_REL)
    _close(tw.grad.numpy(), jw, GRAD_REL)


def _speech_batch(seed=0, B=2, S=4000):
    rng = np.random.RandomState(seed)
    speech = (0.1 * rng.randn(B, S)).astype(np.float32)
    lens = np.asarray([S, S - 500])
    return speech, lens, (np.arange(B) % 2).astype(np.int64)


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_speaker_model_loss_and_every_gradient(encoder):
    kw = dict(n_spk=2, encoder_name=encoder, encoder_conf=ENCODERS[encoder],
              embed_dim=16, frontend_conf=FRONT)
    jmodel = jspk.SpeakerModel(**kw)
    speech, lens, labels = _speech_batch()
    margin = np.float32(0.1)
    args = (jnp.asarray(speech), jnp.asarray(lens), jnp.asarray(labels))
    flat, tree = flax_params(jmodel, *args, seed=11)
    dtype = jnp.float64 if encoder in FLOAT64_HELD else jnp.float32

    def loss_fn(p):
        (loss, stats, _), seen = jmodel.apply(
            p, *args, margin=jnp.asarray(margin, dtype),
            capture_intermediates=lambda m, _: m.name == "projector")
        return loss, (stats, seen["intermediates"]["projector"]["__call__"][0],
                      jmodel.apply(p, args[0], args[1],
                                   method=lambda m, s, n: m._frontend(s, n)))

    with jax.enable_x64(dtype == jnp.float64):
        tree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)
        (jloss, (jstats, jemb, feats)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tree)
    jflat = _flat_grads(jgrads)
    model = convert.load_flax_params(spk.SpeakerModel(**kw), flat).eval()
    t = [torch.from_numpy(x) for x in (speech, lens, labels)]
    loss, stats, weight = model(*t, margin=torch.tensor(margin))
    loss.backward()
    assert weight == 2.0
    with torch.no_grad():
        _close(model.extract_embedding(*t[:2]).numpy(), jemb,
               EMBED_REL.get(encoder, REL))
    _close(float(loss.detach()), float(jloss), GRAD_REL)
    assert float(stats["acc"]) == float(jstats["acc"])
    assert float(stats["margin"]) == float(jstats["margin"]) == margin
    grads = convert.state_dict_to_flax(model, grad=True)
    _grads_close(grads, jflat, FLOAT64_HELD.get(encoder, GRAD_REL))
    if encoder in FLOAT64_HELD:
        m64 = convert.load_flax_params(spk.SpeakerModel(**kw),
                                       flat).eval().double()
        fixed = tuple(torch.from_numpy(np.asarray(x)) for x in feats)
        m64.frontend = lambda *_: (fixed[0].double(), fixed[1])
        loss64 = m64(t[0].double(), *t[1:], margin=torch.tensor(
            margin, dtype=torch.float64))[0]
        loss64.backward()
        _close(float(loss64.detach()), float(jloss), F64_REL)
        _grads_close(convert.state_dict_to_flax(m64, grad=True), jflat,
                     F64_REL)


@pytest.fixture(scope="module")
def asset():
    jmodel, params, _ = JaxSpeakerTask.build_model_from_file(
        ECAPA / "config.yaml", ECAPA)
    model, cfg = SpeakerTask.build_model_from_file(ECAPA / "config.yaml",
                                                   ECAPA, "cpu")
    return jmodel, params, model, cfg


def test_asset_at_full_width(asset):
    """Two held-out utterances as the recipe's stage 3 pads them (74656
    samples, their true lengths): embeddings within 1e-4 of their
    largest."""
    jmodel, params, model, cfg = asset
    assert cfg["encoder_conf"] == {"channels": 256, "num_blocks": 3}
    corpus = SynthSpeechCorpus()
    speech = np.zeros((2, 74656), np.float32)
    lens = np.zeros((2,), np.int64)
    for j in range(2):
        w = corpus.utterance("test", j)[0][:74656]
        speech[j, :len(w)], lens[j] = w, len(w)
    ref = jax.jit(lambda p, s, l: jmodel.apply(
        p, s, l, method=jmodel.extract_embedding))(
        params, jnp.asarray(speech), jnp.asarray(lens.astype(np.int32)))
    with torch.no_grad():
        ours = model.extract_embedding(torch.from_numpy(speech),
                                       torch.from_numpy(lens))
    assert ours.shape == (2, 128)
    _close(ours.numpy(), ref, 1e-4)


def test_asset_converter_round_trip(asset):
    model = asset[2]
    flat = load_checkpoint(ECAPA)[0]
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(flat) and len(flat) == 55
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_grad_pin_finds_every_ecapa_relu(asset):
    names = sorted(grad_pin.relu_inputs(asset[2]))
    assert names == sorted(
        ["encoder.norm_in", "encoder.mfa"]
        + [f"encoder.block{i}.{c}" for i in range(3)
           for c in ("norm1", "norm2", "se1")])


def test_eer_and_min_dcf_on_tied_scores():
    rng = np.random.RandomState(12)
    for _ in range(5):
        scores = np.round(rng.randn(60), 1)     # many ties
        labels = (rng.rand(60) > 0.5).astype(np.int64)
        assert eer.compute_eer(scores, labels) == jeer.compute_eer(scores,
                                                                   labels)
        for p in (0.05, 0.01):
            assert eer.compute_min_dcf(scores, labels, p) == \
                jeer.compute_min_dcf(scores, labels, p)
    assert eer.compute_eer(np.asarray([0.9, 0.1]), np.asarray([1, 0])) == \
        (0.0, 0.9)
    scores, labels = rng.randn(40), (rng.rand(40) > 0.5).astype(np.int64)
    thr = eer.compute_eer(scores, labels)[1]
    mid = eer.operating_points(scores, labels)[0]
    assert thr > mid > np.max(scores[scores < thr], initial=-np.inf)


def test_margin_warm_up():
    cfg = dict(SpeakerTask.default_config(), margin_warmup_epochs=5,
               model_conf={"aam_margin": 0.3, "aam_scale": 30.0})
    ours, theirs = (task.batch_extras_fn(cfg)
                    for task in (SpeakerTask, JaxSpeakerTask))
    for epoch in range(1, 9):
        m = ours(epoch)["margin"]
        assert m.dtype == np.float32 and m.shape == ()
        assert m == theirs(epoch)["margin"]
    assert [float(ours(e)["margin"]) for e in (1, 2, 6)] == [
        0.0, np.float32(0.06), np.float32(0.3)]
    assert SpeakerTask.batch_extras_fn(dict(cfg, margin_warmup_epochs=0)) \
        is None


def _recipe():
    spec = importlib.util.spec_from_file_location(
        "spk1_recipe", ROOT / "egs" / "synth_asr" / "spk1" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def spk_data(tmp_path_factory):
    """The recipe's data dirs at 4 / 4 / 3 utterances, written by both
    packages' ``materialize``, with utt2spkid and each split's trials."""
    root = tmp_path_factory.mktemp("spk")
    SynthSpeechCorpus().materialize(root / "ours", 4, 4, 3)
    JaxCorpus().materialize(root / "theirs", 4, 4, 3)
    data = root / "ours"
    for split in ("train", "valid", "test"):
        with open(data / split / "utt2spkid", "w") as f:
            for line in open(data / split / "utt2spk"):
                u, s = line.split()
                f.write(f"{u} {int(s[3:])}\n")
    return data


def test_materialize_and_trial_lists_match_the_recipe(spk_data):
    recipe = _recipe()
    for split in ("train", "valid", "test"):
        assert (spk_data / split / "utt2spk").read_text() == (
            spk_data.parent / "theirs" / split / "utt2spk").read_text()
    for split, n in (("valid", 8), ("test", 6)):
        ours = spk_inference.write_trials(spk_data, split, n).read_text()
        theirs = recipe.write_trials(spk_data.parent / "theirs", split,
                                     n).read_text()
        assert ours == theirs.replace("theirs", "ours")


def _small_cfg():
    return {"n_spk": 24, "encoder": "ecapa",
            "encoder_conf": {"channels": 16, "num_blocks": 2},
            "embed_dim": 8,
            "model_conf": {"aam_margin": 0.3, "aam_scale": 30.0}}


def _small_model_dir(d, seed=13):
    d.mkdir(parents=True, exist_ok=True)
    cfg = _small_cfg()
    dump_yaml(cfg, d / "config.yaml")
    jmodel = JaxSpeakerTask.build_model(dict(JaxSpeakerTask.task_defaults(),
                                             **cfg))
    flat, tree = flax_params(jmodel, **JaxSpeakerTask.example_batch(cfg),
                             seed=seed)
    np.savez_compressed(d / "params_f16.npz",
                        **{k: v.astype(np.float16) for k, v in flat.items()})
    return d


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    return _small_model_dir(tmp_path_factory.mktemp("model") / "m")


def test_trial_hook_pads_as_the_jax_hook(small_model, spk_data):
    """The valid-epoch hook on 4 utterances: each embedded alone at its
    length bucket with its true length, the EER and minDCF the JAX
    hook's."""
    cfg = {"valid_trial": str(spk_data / "valid" / "trials"),
           "valid_trial_scp": str(spk_data / "valid" / "wav.scp")}
    spk_inference.write_trials(spk_data, "valid", 8)
    jmodel, params, _ = JaxSpeakerTask.build_model_from_file(
        small_model / "config.yaml", small_model)
    theirs = JaxSpeakerTask.build_extra_valid_fn(cfg, jmodel)(params, 1)
    model, _ = SpeakerTask.build_model_from_file(small_model / "config.yaml",
                                                 small_model, "cpu")
    seen, own = [], model.extract_embedding

    def noted(speech, lengths):
        seen.append((speech.shape[1], int(lengths[0]),
                     float(speech[0, int(lengths[0]):].abs().sum())))
        return own(speech, lengths)

    model.extract_embedding = noted
    ours = SpeakerTask.build_extra_valid_fn(cfg)(model, 1)
    assert len(seen) == 4
    assert all(L == bucket_length(n, 4096, 1.3) and tail == 0.0
               for L, n, tail in seen)
    assert ours["eer"] == pytest.approx(theirs["eer"], abs=1e-12)
    assert ours["min_dcf"] == pytest.approx(theirs["min_dcf"], abs=1e-12)


def test_speaker_embedding_and_the_clis_match_jax(small_model, tmp_path):
    """One length throughout (8000 samples; one row of the batch valid to
    5000), so that each JAX instance compiles once."""
    se = spk_inference.SpeakerEmbedding(small_model / "config.yaml",
                                        small_model, device="cpu")
    jse = JaxEmbedding(small_model / "config.yaml", small_model)
    corpus = SynthSpeechCorpus()
    a, b = (corpus.utterance("valid", i)[0][:8000] for i in (0, 1))
    _close(se(a), jse(a), REL)
    speech, lens = np.stack([a, b]), np.asarray([8000, 5000])
    _close(se.embed(speech, lens), jse._extract(
        jse.params, jnp.asarray(speech), jnp.asarray(lens, jnp.int32)), REL)
    assert se.score(a, b) == pytest.approx(jse.score(a, b), abs=1e-5)
    scp = tmp_path / "wav.scp"
    with open(scp, "w") as f:
        for k, w in (("utt_a", a), ("utt_b", b)):
            write_wav(tmp_path / f"{k}.wav", 16000, w)
            f.write(f"{k} {tmp_path / f'{k}.wav'}\n")
    args = ["--train_config", str(small_model / "config.yaml"),
            "--model_file", str(small_model)]
    spk_embed_extract.main(["--output_dir", str(tmp_path / "x_ours"),
                            "--wav_scp", str(scp), *args, "--device", "cpu"])
    jax_extract(tmp_path / "x_theirs", scp, small_model / "config.yaml",
                small_model)
    triples = ["--data_path_and_name_and_type", f"{scp},speech,sound"]
    spk_inference.main(["--output_dir", str(tmp_path / "i_ours"), *triples,
                        *args, "--device", "cpu"])
    jax_spk_main(["--output_dir", str(tmp_path / "i_theirs"), *triples,
                  *args])
    keys = [line.split()[0] for line in open(scp)]
    for ours, theirs, sub in (("x_ours", "x_theirs", ""),
                              ("i_ours", "i_theirs", "embed")):
        assert [line.split()[0] for line in open(
            tmp_path / ours / "embed.scp")] == keys
        for k in keys:
            x = np.load(tmp_path / ours / sub / f"{k}.npy")
            _close(x, np.load(tmp_path / theirs / sub / f"{k}.npy"), REL)
    x0 = np.load(tmp_path / "x_ours" / f"{keys[0]}.npy")
    i0 = np.load(tmp_path / "i_ours" / "embed" / f"{keys[0]}.npy")
    assert x0.shape == (1, 8) and i0.shape == (8,)
    np.testing.assert_array_equal(x0[0], i0)


def test_entry_point_warms_the_margin_validates_and_resumes(small_model,
                                                            spk_data,
                                                            tmp_path):
    """spk_train from the small model: margin 0 then 0.15, the trial EER
    in each valid epoch; two epochs in one run end bit-identical to one
    epoch and a resumed one."""
    spk_inference.write_trials(spk_data, "valid", 8)

    def run(name, max_epoch, resume=False):
        cfg = dict(_small_cfg(), output_dir=str(tmp_path / name),
                   max_epoch=max_epoch, batch_type="unsorted", batch_size=2,
                   num_iters_per_epoch=1, resume=resume, device="cpu",
                   margin_warmup_epochs=2, init_param=str(small_model),
                   collate_fixed_lengths={"speech": 24000},
                   valid_trial=str(spk_data / "valid" / "trials"),
                   valid_trial_scp=str(spk_data / "valid" / "wav.scp"),
                   **{f"{s}_data_path_and_name_and_type": [
                       f"{spk_data}/{s}/wav.scp,speech,sound",
                       f"{spk_data}/{s}/utt2spkid,spk_labels,text_int"]
                      for s in ("train", "valid")})
        dump_yaml(cfg, tmp_path / f"{name}.yaml")
        return spk_train.main(["--config", str(tmp_path / f"{name}.yaml")])

    _, trainer = run("a", 2)
    assert [s["margin"] for s in trainer.step_stats] == [0.0,
                                                         np.float32(0.15)]
    assert all(np.isfinite(s["loss"]) and s["skipped"] == 0.0
               for s in trainer.step_stats)
    for e in (1, 2):
        valid = trainer.reporter.stats[e]["valid"]
        assert 0.0 <= valid["eer"] <= 1.0 and valid["min_dcf"] >= 0.0
        assert "margin" not in valid
    run("b", 1)
    run("b", 2, resume=True)
    a = load_checkpoint(tmp_path / "a" / "checkpoint")[0]
    b = load_checkpoint(tmp_path / "b" / "checkpoint")[0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_build_model_keeps_only_the_encoders_fields():
    cfg = dict(SpeakerTask.default_config(), encoder="rawnet3",
               encoder_conf={"channels": 128, "num_blocks": 2, "ndim": 16,
                             "stem_filters": 8, "out_channels": 12})
    model = SpeakerTask.build_model(cfg)
    assert isinstance(model.encoder, spk.RawNet3Encoder)
    assert model.encoder.cutoffs.shape == (8, 2)
    assert model.pooling.attn2.weight.shape == (12, 128)


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spk_inference.SpeakerEmbedding(ECAPA / "config.yaml", ECAPA)
    se = spk_inference.SpeakerEmbedding(ECAPA / "config.yaml", ECAPA,
                                        device="cpu")
    assert se.device.type == "cpu"
