"""The port's enhancement path against the JAX package, on the CPU: the
iSTFT at odd lengths, the dilated depthwise convolution, the losses and
PIT, the TCN and RNN separators and the conv encoder (with its transposed
convolution's kernel flip), the enhancement model's loss and every
gradient, SeparateSpeech (short and segmented), the streaming class,
the scoring, the mixture corpus, the converter on the enhancement trees
and the committed TCN asset at full width. Training is in
test_torch_enh_train.py, the joint model in test_torch_enh_s2t.py.

Inputs are made with numpy from a seed and fed to both packages. Both
compute in fp32 with sums in another order; each tolerance says why.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import enh_inference as jax_enh_inference
from espnet_tpu.bin import enh_inference_streaming as jax_enh_streaming
from espnet_tpu.bin import enh_scoring as jax_enh_scoring
from espnet_tpu.data import synth_speech as jax_synth
from espnet_tpu.data.fileio import write_wav as jax_write_wav
from espnet_tpu.models.enh import losses as jax_losses
from espnet_tpu.models.enh import separators as jax_separators
from espnet_tpu.models.enh.model import EnhancementModel as JaxEnhancement
from espnet_tpu.nn.convolution import DepthwiseConv1d as JaxDepthwise
from espnet_tpu.ops import stft as jax_stft
from espnet_tpu.tasks.enh import EnhancementTask as JaxEnhancementTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import enh_inference, enh_inference_streaming
from espnet_tpu_torch.bin import enh_scoring
from espnet_tpu_torch.data import synth_speech
from espnet_tpu_torch.data.fileio import SoundScpWriter, read_wav
from espnet_tpu_torch.models.enh import losses, separators
from espnet_tpu_torch.models.enh.model import EnhancementModel
from espnet_tpu_torch.nn.convolution import DepthwiseConv1d
from espnet_tpu_torch.ops import stft
from espnet_tpu_torch.tasks.enh import EnhancementTask
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "assets" / "synth_enh_tcn"
TINY = {"num_spk": 2, "encoder": "stft",
        "encoder_conf": {"n_fft": 128, "hop_length": 32},
        "separator": "tcn",
        "separator_conf": {"layers": 3, "stacks": 1, "bottleneck_dim": 8,
                           "hidden_dim": 16},
        "loss_type": "si_snr"}


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


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b) -> float:
    """Largest |a - b| over b's largest entry."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _waves(rng, *shape, scale=0.3):
    return (scale * rng.randn(*shape)).astype(np.float32)


# ---- ops and layers -------------------------------------------------------

@pytest.mark.parametrize("S,n_fft,hop,length", [
    (1001, 64, 16, 1001), (1001, 64, 16, 996), (777, 512, 128, None),
    (777, 512, 128, 814), (1601, 128, 64, 1601), (333, 100, 25, 333)])
def test_istft_matches_jax_at_odd_lengths(S, n_fft, hop, length,
                                          record_property):
    # the overlap-add adds n_fft / hop frames per sample in another
    # order than JAX's scatter-add: 1e-5 of the largest sample
    x = _waves(np.random.RandomState(S), 2, S)
    real, imag, _ = jax_stft.stft(jnp.asarray(x), None, n_fft=n_fft,
                                  hop_length=hop)
    want = np.asarray(jax_stft.istft(real, imag, n_fft=n_fft,
                                     hop_length=hop, length=length))
    got = stft.istft(_t(real), _t(imag), n_fft=n_fft, hop_length=hop,
                     length=length).numpy()
    assert got.shape == want.shape
    err = _rel(got, want)
    record_property("rel_err:istft", err)
    assert err <= 1e-5
    if length == S:
        # and the port's own round trip gives the signal back
        tr, ti, _ = stft.stft(_t(x), None, n_fft=n_fft, hop_length=hop)
        back = stft.istft(tr, ti, n_fft=n_fft, hop_length=hop, length=S)
        assert _rel(back.numpy(), x) <= 1e-5


@pytest.mark.parametrize("kernel,dilation", [(3, 1), (3, 2), (3, 4),
                                             (3, 8), (4, 3), (5, 2)])
def test_dilated_depthwise_conv_matches_jax(kernel, dilation,
                                            record_property):
    # K products per output: 1e-6 of the largest output
    x = _waves(np.random.RandomState(kernel * 10 + dilation), 2, 37, 6)
    jmod = JaxDepthwise(6, kernel, kernel_dilation=dilation)
    flat, tree = flax_params(jmod, jnp.asarray(x), seed=dilation)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    mod = convert.load_flax_params(DepthwiseConv1d(6, kernel,
                                                   dilation=dilation), flat)
    got = mod(_t(x)).detach().numpy()
    assert got.shape == want.shape == x.shape
    err = _rel(got, want)
    record_property("rel_err:depthwise", err)
    assert err <= 1e-6


@pytest.mark.parametrize("n_spk", [2, 3])
def test_losses_and_pit_match_jax(n_spk, record_property):
    # sums over 500 samples and a log10: 1e-5 relative; the PIT choice
    # must be the same permutation for every utterance
    rng = np.random.RandomState(n_spk)
    B, S = 6, 500
    refs = [_waves(rng, B, S) for _ in range(n_spk)]
    perm = [rng.permutation(n_spk) for _ in range(B)]
    ests = [np.stack([refs[perm[b][i]][b] + _waves(rng, S, scale=0.2)
                      for b in range(B)]) for i in range(n_spk)]
    lens = np.asarray([500, 431, 97, 500, 1, 250])
    for name in ("si_snr", "snr", "l1"):
        for ln in (None, lens):
            want = np.asarray(jax_losses.CRITERIA[name](
                jnp.asarray(ests[0]), jnp.asarray(refs[0]),
                None if ln is None else jnp.asarray(ln)))
            got = losses.CRITERIA[name](
                _t(ests[0]), _t(refs[0]),
                None if ln is None else _t(ln)).numpy()
            assert _rel(got, want) <= 1e-5, name
    want, want_perm = jax_losses.pit_loss(
        jax_losses.si_snr_loss, [jnp.asarray(e) for e in ests],
        [jnp.asarray(r) for r in refs], jnp.asarray(lens))
    got, got_perm = losses.pit_loss(losses.si_snr_loss,
                                    [_t(e) for e in ests],
                                    [_t(r) for r in refs], _t(lens))
    assert got_perm.tolist() == np.asarray(want_perm).tolist()
    err = _rel(got.numpy(), want)
    record_property("rel_err:pit", err)
    assert err <= 1e-5


def test_other_separators_and_output_kinds_raise():
    # the time-domain, multichannel and USES separators are not ported
    # (every output kind and the dpcl loss are); an unknown loss raises
    for name in ("svoice", "fasnet", "uses", "neural_beamformer",
                 "asteroid"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.4"):
            EnhancementModel(separator=name)
    with pytest.raises(ValueError, match="loss_type"):
        EnhancementModel(separator="tcn", loss_type="mixit")
    # every separator of the JAX package's registry has a port entry
    assert set(separators.SEPARATORS) == set(jax_separators.SEPARATORS)


# ---- separators and the model ---------------------------------------------

SEPARATOR_CASES = {
    "tcn": ("stft", "tcn", {"layers": 4, "stacks": 1, "bottleneck_dim": 8,
                            "hidden_dim": 12, "kernel": 3}),
    "tcn_sigmoid": ("stft", "tcn", {"layers": 2, "stacks": 1,
                                    "bottleneck_dim": 8, "hidden_dim": 12,
                                    "nonlinear": "sigmoid"}),
    "rnn": ("stft", "rnn", {"rnn_hidden": 8, "num_layers": 2}),
    "conv_tcn": ("conv", "tcn", {"layers": 2, "stacks": 1,
                                 "bottleneck_dim": 8, "hidden_dim": 12}),
}


def _models(case, seed=0, B=2, S=1000):
    """The JAX and port models of one case with the same weights, and a
    batch: mixtures of two references, ragged lengths."""
    encoder, sep, conf = SEPARATOR_CASES[case]
    kw = dict(num_spk=2, encoder=encoder, separator=sep,
              separator_conf=conf)
    kw.update({"n_fft": 64, "hop_length": 16} if encoder == "stft" else
              {"conv_channels": 16, "conv_kernel": 8, "conv_stride": 4})
    rng = np.random.RandomState(seed)
    r1, r2 = _waves(rng, B, S), _waves(rng, B, S)
    batch = {"speech_mix": r1 + r2,
             "speech_mix_lengths": np.asarray([S, S - 203][:B]),
             "speech_ref1": r1, "speech_ref2": r2}
    jmod = JaxEnhancement(**kw)
    flat, tree = flax_params(jmod, **{k: jnp.asarray(v)
                                      for k, v in batch.items()}, seed=seed)
    kw["separator_conf"] = dict(conf)
    model = convert.load_flax_params(EnhancementModel(**kw), flat)
    return jmod, tree, flat, model, batch


@pytest.mark.parametrize("case", sorted(SEPARATOR_CASES))
def test_separators_match_jax(case, record_property):
    # a few thousand fp32 sums through the separator and the iSTFT:
    # 1e-5 of each estimate's largest sample
    jmod, tree, _, model, batch = _models(case)
    want, _, _ = jax.jit(lambda p, x, n: jmod.apply(
        p, x, n, method=jmod.forward_enhance))(
        tree, jnp.asarray(batch["speech_mix"]),
        jnp.asarray(batch["speech_mix_lengths"]))
    with torch.no_grad():
        got, _, _ = model.forward_enhance(_t(batch["speech_mix"]),
                                          _t(batch["speech_mix_lengths"]))
    errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    record_property(f"rel_err:{case}", max(errs))
    assert len(got) == 2 and max(errs) <= 1e-5


def test_conv_encoder_needs_the_transposed_kernel_flipped():
    # the converter reverses flax's ConvTranspose kernel in K; loaded
    # unreversed, the estimates are far off
    jmod, tree, flat, model, batch = _models("conv_tcn")
    want, _, _ = jax.jit(lambda p, x, n: jmod.apply(
        p, x, n, method=jmod.forward_enhance))(
        tree, jnp.asarray(batch["speech_mix"]),
        jnp.asarray(batch["speech_mix_lengths"]))
    basis = flat["params/basis/kernel"]
    assert np.array_equal(model.basis.weight.detach().numpy(),
                          basis[::-1].transpose(1, 2, 0))
    with torch.no_grad():
        model.basis.weight.copy_(_t(basis.transpose(1, 2, 0)))
        got, _, _ = model.forward_enhance(_t(batch["speech_mix"]),
                                          _t(batch["speech_mix_lengths"]))
    assert _rel(got[0].numpy(), want[0]) > 0.1


@pytest.mark.parametrize("case", ["tcn", "rnn", "conv_tcn"])
def test_enhancement_loss_and_every_gradient_match_jax(case,
                                                       record_property):
    # loss 1e-5 relative; each gradient within 1e-4 of its own largest
    # entry (fp32 backward sums in another order)
    jmod, tree, _, model, batch = _models(case, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jmod.apply(p, **jb)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    jflat = convert.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    loss, stats, weight = model(**{k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert weight == 2.0 and stats["si_snr"].item() == -loss.item()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = convert.state_dict_to_flax(model, grad=True)
    assert set(grads) == set(jflat)
    worst = max(_rel(grads[k], jflat[k]) for k in jflat)
    record_property(f"grad_rel_err:{case}", worst)
    assert worst <= 1e-4


# ---- the API, the stream and the scoring ----------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A TINY model dir laid out as the assets are (config.yaml,
    params_f16.npz), its weights the JAX tree filled from a seed."""
    d = tmp_path_factory.mktemp("enh_tiny")
    dump_yaml(TINY, d / "config.yaml")
    flat, _ = flax_params(JaxEnhancementTask.build_model(TINY),
                          **JaxEnhancementTask.example_batch(TINY))
    np.savez(d / "params_f16.npz",
             **{k: v.astype(np.float16) for k, v in flat.items()})
    return d


@pytest.mark.parametrize("segment_size", [None, 0.1])
def test_separate_speech_matches_jax(tiny_dir, segment_size,
                                     record_property):
    # short (one pass) and segmented (0.1 s windows at 8 kHz, the speaker
    # order aligned by overlap): 1e-5 of each output's largest sample
    kw = dict(train_config=tiny_dir / "config.yaml", model_file=tiny_dir,
              segment_size=segment_size)
    jsep = jax_enh_inference.SeparateSpeech(**kw)
    sep = enh_inference.SeparateSpeech(device="cpu", **kw)
    mix = _waves(np.random.RandomState(7), 2, 2050)
    want, got = jsep(mix), sep(mix)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    record_property(f"rel_err:separate_{segment_size}", max(errs))
    assert [g.shape for g in got] == [(2, 2050)] * 2
    assert max(errs) <= 1e-5
    pretrained = enh_inference.SeparateSpeech.from_pretrained(
        tiny_dir, segment_size=segment_size, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(pretrained(mix), got))


def test_streaming_matches_jax(tiny_dir, record_property):
    # pushes of 300, 170, 800 and 555 samples (the last is_final) through
    # 0.1 s windows: every emitted piece within 1e-5 of the largest
    kw = dict(train_config=tiny_dir / "config.yaml", model_file=tiny_dir,
              segment_size=0.1)
    jstream = jax_enh_streaming.SeparateSpeechStreaming(**kw)
    stream = enh_inference_streaming.SeparateSpeechStreaming(device="cpu",
                                                             **kw)
    audio = _waves(np.random.RandomState(8), 1825)
    worst, start = 0.0, 0
    for size in (300, 170, 800, 555):
        piece = audio[start:start + size]
        start += size
        final = start >= len(audio)
        want, got = jstream(piece, is_final=final), stream(piece,
                                                          is_final=final)
        assert [len(g) for g in got] == [len(w) for w in want]
        worst = max([worst] + [_rel(g, w) for g, w in zip(got, want)
                               if len(w)])
    record_property("rel_err:streaming", worst)
    assert worst <= 1e-5


def test_score_pairs_and_cli_files_match_jax(tmp_path):
    # the same wav files scored by both packages: the same permutation,
    # means within 1e-4 dB, the files line for line to 1e-3 (printed
    # to 4 decimals)
    rng = np.random.RandomState(9)
    scps = {}
    for tag in ("ref1", "ref2", "enh1", "enh2"):
        with SoundScpWriter(tmp_path / tag, tmp_path / f"{tag}.scp") as w:
            for i in range(3):
                w[f"utt{i}"] = (8000, _waves(rng, 900 + 10 * i))
        scps[tag] = str(tmp_path / f"{tag}.scp")
    refs, enhs = [scps["ref1"], scps["ref2"]], [scps["enh2"], scps["enh1"]]
    want = jax_enh_scoring.score_pairs(refs, enhs, tmp_path / "jax")
    got = enh_scoring.score_pairs(refs, enhs, tmp_path / "port")
    for m in want:
        assert abs(got[m] - want[m]) <= 1e-4, m
    for name in ("SI_SNR", "SDR", "SNR"):
        a = [ln.split() for ln in (tmp_path / "jax" / name).read_text()
             .splitlines()]
        b = [ln.split() for ln in (tmp_path / "port" / name).read_text()
             .splitlines()]
        assert [k for k, _ in a] == [k for k, _ in b]
        assert max(abs(float(x) - float(y))
                   for (_, x), (_, y) in zip(a, b)) <= 1e-3
    enh_scoring.main(["--ref_scp", scps["ref1"], "--inf_scp", scps["enh1"],
                      "--output_dir", str(tmp_path / "cli")])
    assert (tmp_path / "cli" / "RESULTS").read_text().startswith("si_snr:")


def test_inference_writes_what_separate_speech_returns(tiny_dir, tmp_path):
    rng = np.random.RandomState(10)
    mixes = {f"m{i}": _waves(rng, 1500 + 7 * i) for i in range(3)}
    with SoundScpWriter(tmp_path / "wav", tmp_path / "wav.scp") as w:
        for k, v in mixes.items():
            w[k] = (8000, v)
    enh_inference.main([
        "--output_dir", str(tmp_path / "out"),
        "--data_path_and_name_and_type",
        f"{tmp_path / 'wav.scp'},speech_mix,sound",
        "--train_config", str(tiny_dir / "config.yaml"),
        "--model_file", str(tiny_dir), "--device", "cpu"])
    sep = enh_inference.SeparateSpeech(tiny_dir / "config.yaml", tiny_dir,
                                       device="cpu")
    for k in mixes:
        _, read_back = read_wav(tmp_path / "wav" / f"{k}.wav")
        ests = sep(read_back)
        for s in (1, 2):
            lines = dict(ln.split() for ln in (tmp_path / "out"
                                               / f"spk{s}.scp")
                         .read_text().splitlines())
            rate, wav = read_wav(lines[k])
            # the same separation, written as 16-bit PCM and read back
            want = (np.clip(ests[s - 1][0], -1, 1) * 32767).astype(
                np.int16) / np.float32(32768)
            assert rate == 8000 and np.array_equal(wav, want)


def test_entry_points_raise_without_a_card(tiny_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enh_inference.SeparateSpeech(tiny_dir / "config.yaml", tiny_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnhancementTask.build_model_from_file(tiny_dir / "config.yaml",
                                              tiny_dir)


# ---- data -----------------------------------------------------------------

def test_synth_mix_corpus_equals_jax(tmp_path):
    # the same mixtures sample for sample, and the same files
    jc, pc = jax_synth.SynthMixCorpus(seconds=0.5), \
        synth_speech.SynthMixCorpus(seconds=0.5)
    for split, i in (("train", 0), ("valid", 3), ("test", 1)):
        for a, b in zip(jc.mixture(split, i), pc.mixture(split, i)):
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b)
    jc.materialize(tmp_path / "jax", n_train=2, n_valid=0, n_test=1)
    pc.materialize(tmp_path / "port", n_train=2, n_valid=0, n_test=1)
    for split in ("train", "test"):
        for name in ("wav.scp", "spk1.scp", "spk2.scp", "speech_mix_shape"):
            a = (tmp_path / "jax" / split / name).read_text()
            b = (tmp_path / "port" / split / name).read_text()
            assert a.replace(str(tmp_path / "jax"), "") == \
                b.replace(str(tmp_path / "port"), "")
        for wav in sorted((tmp_path / "jax" / split / "wav").iterdir()):
            assert wav.read_bytes() == (tmp_path / "port" / split / "wav"
                                        / wav.name).read_bytes()
    assert not (tmp_path / "port" / "valid").exists()
    # the JAX writer and the port's write the same bytes
    x = _waves(np.random.RandomState(11), 301, scale=0.8)
    jax_write_wav(tmp_path / "a.wav", 16000, x)
    SoundScpWriter(tmp_path / "b", tmp_path / "b.scp")["a"] = (16000, x)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b" / "a.wav").read_bytes()


# ---- the converter and the asset ------------------------------------------

def _shape_rule(value):
    """The converter's former kernel rule, by the flax array's shape
    alone: (in, out) -> .T, 4-D -> (O, C, kt, kf), and (K, 1, C) ->
    (C, 1, K); anything else raised."""
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 3 and value.shape[1] == 1:
        return value.transpose(2, 1, 0)
    raise ValueError(f"unexpected kernel shape {value.shape}")


def test_converter_maps_the_enhancement_trees():
    flat = convert.read_npz(ASSET / "params_f16.npz")
    # the shape rule refused the asset's pointwise kernels
    for key in ("params/separator_mod/bottleneck/kernel",
                "params/separator_mod/mask_out/kernel"):
        with pytest.raises(ValueError, match="unexpected kernel shape"):
            _shape_rule(flat[key])
    assert flat["params/separator_mod/PReLU_0/negative_slope"].shape == ()
    model, _ = EnhancementTask.build_model_from_file(
        ASSET / "config.yaml", ASSET, "cpu")
    sep = model.separator_mod
    assert np.array_equal(
        sep.bottleneck.weight.detach().numpy(),
        flat["params/separator_mod/bottleneck/kernel"][0].T)
    assert sep.tcn1_3.PReLU_1.negative_slope.shape == ()
    assert sep.tcn1_3.dconv.dilation == 8
    back = convert.state_dict_to_flax(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    # the conv encoder: the shape rule refused the transposed
    # convolution's (K, in, 1) kernel, and took the filterbank's
    # (K, 1, N) as a depthwise kernel (right only by coincidence)
    _, _, cflat, cmodel, _ = _models("conv_tcn")
    with pytest.raises(ValueError, match="unexpected kernel shape"):
        _shape_rule(cflat["params/basis/kernel"])
    cback = convert.state_dict_to_flax(cmodel)
    assert set(cback) == set(cflat)
    assert all(np.array_equal(cback[k], v) for k, v in cflat.items())


def test_asset_at_full_width_matches_jax(record_property):
    # the TCN asset on two 4 s test mixtures: the separated waves within
    # 1e-5 of their largest sample, the PIT loss 1e-5 relative
    jmodel, jparams, _ = JaxEnhancementTask.build_model_from_file(
        ASSET / "config.yaml", ASSET)
    model, cfg = EnhancementTask.build_model_from_file(
        ASSET / "config.yaml", ASSET, "cpu")
    assert cfg["separator"] == "tcn" and cfg["steps_per_dispatch"] == 8
    corpus = synth_speech.SynthMixCorpus()
    mix, r1, r2 = map(np.stack, zip(*[corpus.mixture("test", i)
                                      for i in range(2)]))
    lens = np.full((2,), mix.shape[1])
    want, _, _ = jmodel.apply(jparams, jnp.asarray(mix), jnp.asarray(lens),
                              method=jmodel.forward_enhance)
    with torch.no_grad():
        got, _, _ = model.forward_enhance(_t(mix), _t(lens))
        loss = model(_t(mix), _t(lens), _t(r1), _t(r2))[0]
    errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    record_property("rel_err:asset", max(errs))
    assert max(errs) <= 1e-5
    jloss = jmodel.apply(jparams, jnp.asarray(mix), jnp.asarray(lens),
                         jnp.asarray(r1), jnp.asarray(r2))[0]
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
