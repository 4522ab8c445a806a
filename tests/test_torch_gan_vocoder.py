"""The port's HiFi-GAN vocoder task against the JAX package, on the CPU:
``featurize``, both turns of HiFiGANVocoderGAN (loss, stats and every
gradient, from wave-derived log-mels and from given ones), the
preprocessor's crops, and the ``gan_vocoder_train`` entry point.

A small vocoder (n_fft 64, hop 32, 12 mels; generator 16 channels x4 x8;
periods (2, 3), 1 scale) whose weights fill the JAX tree from a numpy
seed. Log-mels are held to 1e-5 of their largest entry, losses and
gradients to 1e-4 of the largest entry of their turn (fp32 in another
order through a generator and three discriminators).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from espnet_tpu.models.tts.gan_vocoder import HiFiGANVocoderGAN as JaxVocoder
from espnet_tpu.tasks.gan_tts import GANVocoderTask as JaxGANVocoderTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import gan_vocoder_train
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.models.tts.gan_vocoder import HiFiGANVocoderGAN
from espnet_tpu_torch.tasks.gan_tts import GANVocoderTask
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

REL = 1e-5
GRAD_REL = 1e-4
CONF = dict(fs=8000, n_fft=64, hop_length=32, n_mels=12,
            generator_conf=dict(channels=16, upsample_scales=(4, 8),
                                upsample_kernel_sizes=(8, 16),
                                resblock_kernel_sizes=(3,),
                                resblock_dilations=((1, 3),)),
            discriminator_conf=dict(periods=(2, 3), scales=1))
SEG = 256


def _wave(seed, B=3):
    return (0.3 * np.random.RandomState(seed).randn(B, SEG)).astype(
        np.float32)


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
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
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), err


def _flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(dict(tree)).items()}


@pytest.fixture(scope="module")
def vocoder():
    jvoc = JaxVocoder(**CONF)
    mel = np.zeros((1, SEG // 32, 12), np.float32)
    gflat, _ = flax_params(jvoc.generator, mel, seed=1)
    dflat, _ = flax_params(jvoc.discriminator,
                           np.zeros((1, SEG), np.float32), seed=2)
    flat = {**{f"generator/{k}": v for k, v in gflat.items()},
            **{f"discriminator/{k}": v for k, v in dflat.items()}}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    model = convert.load_flax_params(HiFiGANVocoderGAN(**CONF), flat)
    return jvoc, tree, model, flat


def test_featurize_matches_jax(vocoder):
    jvoc, _, model, _ = vocoder
    wav = _wave(0)
    ref = jax.jit(jvoc.featurize)(jnp.asarray(wav))
    with torch.no_grad():
        ours = model.featurize(torch.from_numpy(wav))
    assert ours.shape == (3, SEG // 32, 12)
    _close(ours.numpy(), ref, REL)


BATCHES = {False: {"speech": _wave(1)},
           # a teacher-forced fine-tune's log-mels
           True: {"speech": _wave(1), "feats": np.random.RandomState(
               2).randn(3, SEG // 32, 12).astype(np.float32)}}


@pytest.fixture(scope="module")
def jax_turns(vocoder):
    """Both turns' loss, stats and gradients by the JAX package, for both
    batches, in one compiled program."""
    jvoc, tree, _, _ = vocoder

    def turns(p, batches):
        out = {}
        for key, jb in batches.items():
            for gen_turn, part in ((True, "generator"),
                                   (False, "discriminator")):
                def loss_fn(sub, gen_turn=gen_turn, part=part, jb=jb):
                    loss, stats, _ = jvoc.apply({**p, part: sub}, jb, None,
                                                gen_turn)
                    return loss, stats
                out[key, part] = jax.value_and_grad(
                    loss_fn, has_aux=True)(p[part])
        return out

    return jax.jit(turns)(tree, {str(k): {n: jnp.asarray(v) for n, v in
                                          b.items()}
                                 for k, b in BATCHES.items()})


@pytest.mark.parametrize("with_feats", [False, True])
def test_both_turns_loss_and_every_gradient(vocoder, jax_turns,
                                            with_feats):
    model = vocoder[2]
    batch = BATCHES[with_feats]
    for gen_turn, part in ((True, "generator"), (False, "discriminator")):
        (jloss, jstats), jgrads = jax_turns[str(with_feats), part]
        model.zero_grad()
        loss, stats, weight = model(
            **{k: torch.from_numpy(v) for k, v in batch.items()},
            forward_generator=gen_turn)
        loss.backward()
        assert weight == 3.0
        _close(float(loss), float(jloss), GRAD_REL)
        for k, v in jstats.items():
            _close(float(stats[k]), float(v), GRAD_REL)
        grads = convert.state_dict_to_flax(getattr(model, part), grad=True)
        jflat = _flat(jgrads)
        assert sorted(grads) == sorted(jflat)
        top = max(float(np.abs(g).max()) for g in jflat.values())
        for name, g in jflat.items():
            err = float(np.abs(grads[name] - g).max())
            assert err <= GRAD_REL * top, (part, name, err, top)


def test_preprocess_crops():
    """Validation crops the centre, as the JAX package does, and aligns a
    given log-mel on frame boundaries; training crops at random, the same
    way in the same epoch and utterance (a resumed run repeats it), in
    bounds; short waves are zero-padded."""
    cfg = dict(GANVocoderTask.default_config(), segment_size=SEG,
               hop_length=32, seed=3)
    jcfg = dict(JaxGANVocoderTask.default_config(), segment_size=SEG,
                hop_length=32, seed=3)
    rng = np.random.RandomState(4)
    w = rng.randn(1000).astype(np.float32)
    feats = rng.randn(31, 12).astype(np.float32)
    ours = GANVocoderTask.build_preprocess_fn(cfg, train=False)
    theirs = JaxGANVocoderTask.build_preprocess_fn(jcfg, train=False)
    for data in ({"speech": w}, {"speech": w, "feats": feats},
                 {"speech": w[:100]}, {"speech": w[:100],
                                       "feats": feats[:3]}):
        a, b = ours("u", dict(data)), theirs("u", dict(data))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    train = GANVocoderTask.build_preprocess_fn(cfg, train=True)
    starts = set()
    for epoch in (1, 2, 3):
        a = train("u", {"speech": w}, epoch=epoch)["speech"]
        np.testing.assert_array_equal(
            a, train("u", {"speech": w}, epoch=epoch)["speech"])
        s = int(np.flatnonzero(np.isclose(w, a[0]))[0])
        np.testing.assert_array_equal(w[s:s + SEG], a)
        starts.add(s)
        out = train("u", {"speech": w, "feats": feats}, epoch=epoch)
        s_f = int(np.flatnonzero(np.isclose(w, out["speech"][0]))[0]) // 32
        np.testing.assert_array_equal(out["speech"], w[s_f * 32:
                                                       s_f * 32 + SEG])
        np.testing.assert_array_equal(out["feats"],
                                      feats[s_f:s_f + SEG // 32])
    assert len(starts) > 1


def test_entry_point_trains_checkpoints_and_resumes(tmp_path):
    """gan_vocoder_train on the small config, one step an epoch: two
    epochs in one run end bit-identical to one epoch and a resumed one."""
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=4,
                                    n_valid=2, n_test=0)
    data = tmp_path / "data"
    runs, trainers = {}, {}
    for name, stops in (("whole", [2]), ("resumed", [1, 2])):
        for max_epoch in stops:
            cfg = dict(CONF, output_dir=str(tmp_path / name),
                       segment_size=SEG, batch_size=2, max_epoch=max_epoch,
                       num_iters_per_epoch=1, log_interval=1, resume=True,
                       device="cpu",
                       train_data_path_and_name_and_type=[
                           f"{data}/train/wav.scp,speech,sound"],
                       valid_data_path_and_name_and_type=[
                           f"{data}/valid/wav.scp,speech,sound"])
            dump_yaml(cfg, tmp_path / f"{name}.yaml")
            _, trainers[name] = gan_vocoder_train.main(
                ["--config", str(tmp_path / f"{name}.yaml")])
        runs[name] = load_checkpoint(tmp_path / name / "checkpoint")[0]
    steps = trainers["whole"].step_stats
    assert len(steps) == 2 and all(
        np.isfinite(s["generator_loss"]) and not s["skipped"]
        and not s["skipped_d"] for s in steps)
    assert {k.split("/")[0] for k in runs["whole"]} == {"generator",
                                                        "discriminator"}
    for k, v in runs["whole"].items():
        np.testing.assert_array_equal(runs["resumed"][k], v, err_msg=k)
    valid = trainers["whole"].reporter.stats[2]["valid"]
    assert valid["loss"] == valid["generator_loss"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gan_vocoder_train.main(["--config", str(tmp_path / "whole.yaml"),
                                    "--device", "null"])


@pytest.mark.parametrize("generator", ["melgan", "style_melgan",
                                       "parallel_wavegan"])
def test_unported_generators_raise(generator):
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        HiFiGANVocoderGAN(generator=generator)
