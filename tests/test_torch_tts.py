"""The port's VITS serving slice against the JAX package, on the CPU: the
``embed`` input layer, the variance predictor, the length regulator, the
posterior encoder, the coupling flow (forward, inverse, round trip), the
HiFi-GAN generator at odd T with flax's SAME transposed convolutions,
and VITS.inference on the same noise, on a small VITS (z 8, hidden 12,
1 text block, generator 16 channels x4 x2, 25 tokens) whose weights fill
the JAX tree from a numpy seed; the committed asset at full width
(max_frames 64); the converter; Text2Speech and the batch-synthesis CLI.

Durations are integers and must be equal. Activations and waves are
fp32 in another order: held to 1e-5 of their largest entry (1e-4 for
the asset's wave, through 4 text blocks, 4 couplings and a generator
of 43 convolutions up to 256 channels wide: measured 3.2e-5), and the
flow's round trip to 1e-5 of its input.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from espnet_tpu.bin import tts_inference as jax_tts_inference
from espnet_tpu.models.tts import fastspeech2 as jax_fs2
from espnet_tpu.models.tts.hifigan import HiFiGANGenerator as JaxGenerator
from espnet_tpu.models.tts.vits import PosteriorEncoder as JaxPosterior
from espnet_tpu.models.tts.vits import ResidualCouplingFlow as JaxFlow
from espnet_tpu.models.tts.vits import VITS as JaxVITS
from espnet_tpu.nn.transformer import TransformerEncoder as JaxEncoder
from espnet_tpu.tasks.gan_tts import GANTTSTask as JaxGANTTSTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import tts_inference
from espnet_tpu_torch.data.fileio import SoundScpReader
from espnet_tpu_torch.models.tts.fastspeech2 import (VariancePredictor,
                                                     length_regulator)
from espnet_tpu_torch.models.tts.hifigan import HiFiGANGenerator
from espnet_tpu_torch.models.tts.vits import (VITS, PosteriorEncoder,
                                              ResidualCouplingFlow)
from espnet_tpu_torch.nn.convolution import SameConvTranspose1d
from espnet_tpu_torch.nn.transformer import TransformerEncoder
from espnet_tpu_torch.tasks.gan_tts import GANTTSTask
from scripts.jax_tts_lm_reference import jax_vits_infer
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "assets" / "synth_tts_vits"
V = 25
REL = 1e-5
WAVE_REL = 1e-4
GEN = {"channels": 16, "upsample_scales": (4, 2),
       "upsample_kernel_sizes": (8, 4), "kernel_size": 5,
       "resblock_kernel_sizes": (3, 5), "resblock_dilations": ((1, 3),
                                                               (1, 2))}
SMALL = {"z_channels": 8, "hidden": 12, "spec_channels": 17,
         "segment_frames": 4, "hop_length": 8,
         "text_encoder_conf": {"output_size": 12, "attention_heads": 2,
                               "linear_units": 16, "num_blocks": 1},
         "generator_conf": GEN}


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err
    return err


def _apply(module, tree, *args, **kwargs):
    """module.apply, compiled: faster than JAX's op-by-op dispatch."""
    return jax.jit(lambda p, *a: module.apply(p, *a, **kwargs))(
        tree, *map(jnp.asarray, args))


def _load(module, flat):
    return convert.load_flax_params(module, flat).eval()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(0)


def _valid(lens, T):
    return np.arange(T)[None] < np.asarray(lens)[:, None]


def test_embed_input_layer(rng):
    ids = rng.randint(0, V, size=(3, 9)).astype(np.int32)
    lens = np.asarray([9, 5, 1], np.int32)
    conf = dict(output_size=12, attention_heads=2, linear_units=16,
                num_blocks=2, input_layer="embed")
    jenc = JaxEncoder(input_size=V, **conf)
    flat, tree = flax_params(jenc, ids, lens, seed=1)
    ref, rlens = _apply(jenc, tree, ids, lens)
    with torch.no_grad():
        out, olens = _load(TransformerEncoder(V, **conf), flat)(
            _t(ids).long(), _t(lens).long())
    np.testing.assert_array_equal(olens.numpy(), np.asarray(rlens))
    _rel_close(out.numpy(), ref)


def test_variance_predictor_and_length_regulator(rng):
    x = rng.randn(2, 7, 12).astype(np.float32)
    mask = _valid([7, 4], 7)
    jvp = jax_fs2.VariancePredictor(chans=12)
    flat, tree = flax_params(jvp, x, mask, seed=2)
    with torch.no_grad():
        d = _load(VariancePredictor(12, chans=12), flat)(_t(x), _t(mask))
    _rel_close(d.numpy(), _apply(jvp, tree, x, mask))
    dur = np.asarray([[2, 0, 3, 1, 0, 4, 1], [1, 1, 0, 2, 0, 0, 0]],
                     np.int64)
    jax_lr = jax.jit(jax_fs2.length_regulator, static_argnums=2)
    for out_len in (5, 12, 20):     # shorter and longer than the totals
        frames, total = length_regulator(_t(x), _t(dur), out_len)
        rf, rt = jax_lr(jnp.asarray(x), jnp.asarray(dur), out_len)
        np.testing.assert_array_equal(frames.numpy(), np.asarray(rf))
        np.testing.assert_array_equal(total.numpy(), np.asarray(rt))


def test_posterior_encoder(rng):
    spec = np.abs(rng.randn(2, 11, 17)).astype(np.float32) * 5
    mask = _valid([11, 6], 11)
    jpost = JaxPosterior(8, 12)
    key = jax.random.PRNGKey(3)
    flat, tree = flax_params(jpost, spec, mask, key, seed=3)
    rz, rm, rlogs = _apply(jpost, tree, spec, mask, key)
    noise = np.asarray(jax.random.normal(key, (2, 11, 8)))
    with torch.no_grad():
        z, m, logs = _load(PosteriorEncoder(17, 8, 12), flat)(
            _t(spec), _t(mask), _t(noise))
    for ours, ref in ((z, rz), (m, rm), (logs, rlogs)):
        _rel_close(ours.numpy(), ref)


def test_coupling_flow_forward_inverse_round_trip(rng):
    x = rng.randn(2, 13, 8).astype(np.float32)
    mask = _valid([13, 8], 13)
    x = x * mask[..., None]
    jflow = JaxFlow(hidden=12)
    flat, tree = flax_params(jflow, x, mask, seed=4)
    flow = _load(ResidualCouplingFlow(8, hidden=12), flat)
    with torch.no_grad():
        fwd = flow(_t(x), _t(mask))
        inv = flow(_t(x), _t(mask), reverse=True)
        back = flow(fwd, _t(mask), reverse=True)
    _rel_close(fwd.numpy(), _apply(jflow, tree, x, mask))
    _rel_close(inv.numpy(), _apply(jflow, tree, x, mask, reverse=True))
    _rel_close(back.numpy(), x)


@pytest.mark.parametrize("k,s", [(16, 8), (8, 4), (3, 4)])
def test_transposed_conv_same_alignment(rng, k, s):
    """flax's ConvTranspose SAME at odd T: torch's transposed convolution
    as it is, padded by K - 1 on both sides, gives (T - 1) s + K outputs
    shifted against flax's; SameConvTranspose1d keeps flax's T * s."""
    import flax.linen as fnn
    T = 7
    x = rng.randn(2, T, 5).astype(np.float32)
    jconv = fnn.ConvTranspose(3, (k,), strides=(s,), padding="SAME")
    flat, tree = flax_params(jconv, x, seed=k + s)
    ref = np.asarray(jconv.apply(tree, jnp.asarray(x))).transpose(0, 2, 1)
    conv = _load(SameConvTranspose1d(5, 3, k, s), flat)
    plain = _load(torch.nn.ConvTranspose1d(5, 3, k, stride=s), flat)
    with torch.no_grad():
        ours = conv(_t(x).transpose(1, 2))
        old = plain(_t(x).transpose(1, 2))
    assert ref.shape[2] == T * s and old.shape[2] == (T - 1) * s + k
    if conv.crop:
        assert np.abs(old[..., :T * s].numpy() - ref).max() > 1e-2
    _rel_close(ours.numpy(), ref)


def test_hifigan_generator_at_odd_length(rng):
    mel = rng.randn(2, 7, 8).astype(np.float32)
    conf = dict(GEN, upsample_scales=(8, 4), upsample_kernel_sizes=(16, 8))
    jgen = JaxGenerator(in_channels=8, **conf)
    flat, tree = flax_params(jgen, mel, seed=6)
    with torch.no_grad():
        wav = _load(HiFiGANGenerator(in_channels=8, **conf), flat)(_t(mel))
    assert wav.shape == (2, 7 * 32)
    _rel_close(wav.numpy(), _apply(jgen, tree, mel))


@pytest.fixture(scope="module")
def small_vits():
    text = np.ones((2, 6), np.int32)
    spec = np.zeros((2, 12, 17), np.float32)
    jvits = JaxVITS(vocab_size=V, **SMALL)
    flat, _ = flax_params(jvits, text, np.asarray([6, 4], np.int32),
                          spec, np.asarray([12, 10], np.int32),
                          jax.random.PRNGKey(0), seed=7)
    # log durations near log 3, so that the texts take 1-4 frames a token
    flat["params/duration_predictor/linear/bias"] = np.asarray(
        [1.2], np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    return jvits, tree, _load(VITS(V, **SMALL), flat)


def test_vits_inference_same_noise(small_vits, rng):
    jvits, tree, vits = small_vits
    text = rng.randint(1, V, size=(2, 6)).astype(np.int32)
    lens = np.asarray([6, 3], np.int32)
    noise = rng.randn(2, 24, 8).astype(np.float32)
    ref_wav, ref_olens, ref_dur = jax.jit(lambda p, t, tl, n: jvits.apply(
        p, t, tl, n, 0.667, 24, method=jax_vits_infer))(
        tree, jnp.asarray(text), jnp.asarray(lens), jnp.asarray(noise))
    with torch.no_grad():
        dur = vits.prior_and_durations(_t(text).long(), _t(lens).long())[2]
        wav, olens = vits.inference(_t(text).long(), _t(lens).long(),
                                    noise=_t(noise), max_frames=24)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(ref_dur))
    np.testing.assert_array_equal(olens.numpy(), np.asarray(ref_olens))
    assert 0 < int(olens.min()) and wav.shape == (2, 24 * 8)
    _rel_close(wav.numpy(), ref_wav)


@pytest.fixture(scope="module")
def asset():
    jmodel, jparams, jcfg = JaxGANTTSTask.build_model_from_file(
        ASSET / "config.yaml", ASSET)
    model, cfg = GANTTSTask.build_model_from_file(ASSET / "config.yaml",
                                                  ASSET, "cpu")
    return jmodel.inner.generator, jparams["generator"], model, cfg


def _asset_ids(cfg, text):
    ids = GANTTSTask.build_preprocess_fn(cfg, train=False)(
        "x", {"text": text, "speech": np.zeros(512, np.float32)})["text"]
    t = np.zeros((1, 64), np.int32)
    t[0, :len(ids)] = ids
    return t, np.asarray([len(ids)], np.int32)


def test_vits_asset_full_width(asset):
    """The committed VITS (z 192, 4 text blocks, generator 256 channels
    x8 x4 x4) at max_frames 64 on one text and numpy noise: durations
    equal, the wave within 1e-4 of its largest sample."""
    gen, params, model, cfg = asset
    text, lens = _asset_ids(cfg, "deka munto ra")
    noise = np.random.RandomState(1000).randn(1, 64, 192).astype(np.float32)
    ref_wav, ref_olens, ref_dur = jax.jit(lambda p, t, tl, n: gen.apply(
        p, t, tl, n, 0.333, 64, method=jax_vits_infer))(
        params, jnp.asarray(text), jnp.asarray(lens), jnp.asarray(noise))
    with torch.no_grad():
        dur = model.generator.prior_and_durations(_t(text).long(),
                                                  _t(lens).long())[2]
        wav, olens = model.decode(_t(text).long(), _t(lens).long(),
                                  noise=_t(noise), noise_scale=0.333,
                                  max_frames=64)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(ref_dur))
    n = int(olens[0]) * cfg["hop_length"]
    assert int(olens[0]) == int(ref_olens[0]) > 0
    _rel_close(wav[0, :n].numpy(), np.asarray(ref_wav)[0, :n], WAVE_REL)


def test_vits_converter_subtree(asset):
    """The generator part loads strictly and round-trips bit for bit; the
    old rule, a whole tree rooted at params/, refuses the checkpoint; the
    discriminator's 54 arrays are named and left out."""
    model = asset[2]
    flat = convert.read_npz(ASSET / "params_f16.npz")
    with pytest.raises(KeyError):
        convert.load_flax_params(GANTTSTask.build_model(asset[3]).generator,
                                 flat)
    inner, left_out = convert.take_subtree(flat, "generator")
    assert left_out == {"discriminator": 54} and len(inner) == 201
    back = convert.state_dict_to_flax(model.generator)
    assert sorted(back) == sorted(inner)
    for key, value in inner.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


TEXTS = {"valid_00000": "deka munto"}


def test_text2speech_and_cli_against_jax(asset, tmp_path):
    """Text2Speech at its default 512 frames on JAX's own noise (its
    PRNGKey(0) draw) gives JAX's wave; the CLI writes, for each key, a
    wave as long (the durations do not depend on the noise) and equal to
    the port's API's with its seeded generator."""
    text_file = tmp_path / "text"
    text_file.write_text("".join(f"{k} {t}\n" for k, t in TEXTS.items()))
    kw = dict(train_config=str(ASSET / "config.yaml"),
              model_file=str(ASSET))
    jt2s = jax_tts_inference.Text2Speech(**kw)
    t2s = tts_inference.Text2Speech.from_pretrained(ASSET, device="cpu")
    ra, _ = jax.random.split(jax.random.PRNGKey(0))
    noise = np.array(jax.random.normal(ra, (1, 512, 192)))
    refs = {key: jt2s(text)["wav"] for key, text in TEXTS.items()}
    ours = t2s(TEXTS["valid_00000"], noise=noise)["wav"]
    _rel_close(ours, refs["valid_00000"], WAVE_REL)
    tts_inference.main(["--output_dir", str(tmp_path / "port"),
                        "--data_path_and_name_and_type",
                        f"{text_file},text,text", "--device", "cpu"]
                       + [f"--{k}={v}" for k, v in kw.items()])
    wavs = SoundScpReader(tmp_path / "port" / "wav.scp")
    assert list(wavs.keys()) == list(TEXTS)
    for key, text in TEXTS.items():
        rate, wav = wavs[key]
        assert rate == 16000 and len(wav) == len(refs[key])
        np.testing.assert_allclose(wav, t2s(text)["wav"], atol=1.5 / 32768)


@pytest.mark.parametrize("what", ["jets", "visinger", "use_sdp", "vocoder",
                                  "gan_vocoder"])
def test_unported_tts_paths_raise(what, tmp_path):
    """The slice's neighbours raise, naming ROADMAP A.5."""
    from espnet_tpu_torch.tasks.gan_tts import GANVocoderTask
    from espnet_tpu_torch.utils.config import load_yaml
    cfg = dict(load_yaml(ASSET / "config.yaml"),
               token_list=str(ASSET / "tokens.txt"))
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        if what in ("jets", "visinger"):
            GANTTSTask.build_model(dict(cfg, tts=what))
        elif what == "use_sdp":
            VITS(V, **dict(SMALL, use_sdp=True))
        elif what == "vocoder":
            tts_inference.Text2Speech(ASSET / "config.yaml", ASSET,
                                      vocoder_file=tmp_path, device="cpu")
        else:   # the HiFi-GAN vocoder is ported; its other generators wait
            GANVocoderTask.build_model(dict(cfg, generator="melgan"))
