"""The port's neural codec against the JAX package, on the CPU: Snake,
the residual VQ (codes, quantized values, commit loss and lookup, with
and without DAC's projections), the loss and every gradient of the three
codec types (SoundStream, Encodec, DAC), the committed SoundStream asset
at full width, its converter round trip, ``CodecCoder`` and the CLI, and
the ``gan_codec_train`` entry point with a resume.

Encodec's and DAC's multi-scale STFT loss takes the log of amplitudes
down to ~2e-4 of the peak, where the gradient 1 / |X| turns the fp32
rounding of the STFT into ~1e-3 of the largest gradient: against the
port's float64 backward the JAX package's fp32 gradients measured
3.6e-3 (Encodec) and 3.8e-5 (DAC), the port's 2.2e-5 and 3.0e-4 (8
threads; 1.3e-3 for Encodec at one thread, another summation order).
So those two types are held to JAX's at MULTI_SCALE_REL; SoundStream
(the asset's log-mel loss) is held to JAX's at 1e-4.

Small codecs fill the JAX tree from a numpy seed
(``tests/torch_streaming_models.py:flax_params``). Codes must be equal
wherever the JAX package's two best distances are not within 1e-4 of
each other (relative); activations are held to 1e-5 of their largest
entry, losses and gradients to 1e-4 of the largest entry, the asset's
waves to 1e-4 of their largest sample.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from espnet_tpu.bin.gan_codec_inference import CodecCoder as JaxCodecCoder
from espnet_tpu.bin.gan_codec_inference import inference as jax_inference
from espnet_tpu.models.codec import CodecModel as JaxCodecModel
from espnet_tpu.models.codec import ResidualVQ as JaxResidualVQ
from espnet_tpu.models.codec import snake as jax_snake
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import gan_codec_inference, gan_codec_train
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.models.codec import CodecModel, ResidualVQ, snake
from espnet_tpu_torch.tasks.ssl import CodecTask
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
CODEC = ROOT / "assets" / "synth_codec"
REL = 1e-5
GRAD_REL = 1e-4
TIE = 1e-4
MULTI_SCALE_REL = 5e-3
SMALL = dict(channels=4, strides=(2, 4), code_dim=8, num_quantizers=2,
             codebook_size=16)
S = 640


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


def _snake_alphas_near_one(flat):
    """flax_params draws alpha ~ N(0, 0.05^2); flax starts it at ones,
    and near 0 a snake divides by its clamp (1e-9). -> flat, tree with
    every alpha 1 + N(0, 0.05^2), and the decoder's output kernel at a
    tenth, so that its tanh is not saturated (where 1 - tanh^2 cancels
    and the two packages' gradients part)."""
    from flax.traverse_util import unflatten_dict
    flat = {k: (1.0 + v if k.endswith("/alpha")
                else 0.1 * v if k == "params/decoder/out/kernel" else v)
            for k, v in flat.items()}
    return flat, unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                 for k, v in flat.items()})


def _wave(seed, B=2, n=S):
    t = np.arange(n) / 8000.0
    rng = np.random.RandomState(seed)
    w = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900, (B, 1)) * t)
    return (w + 0.05 * rng.randn(B, n)).astype(np.float32)


def test_snake_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 7).astype(np.float32)
    alpha = np.abs(rng.randn(7)).astype(np.float32)
    alpha[0] = 0.0
    ref = jax_snake(jnp.asarray(x), jnp.asarray(alpha))
    ours = snake(torch.from_numpy(x), torch.from_numpy(alpha))
    _close(ours.numpy(), ref, REL)


def _margins(d):
    """(second best - best) / |best| over the last axis."""
    two = np.sort(d, axis=-1)[..., :2]
    return (two[..., 1] - two[..., 0]) / np.maximum(np.abs(two[..., 0]),
                                                    1e-30)


@pytest.mark.parametrize("proj_dim", [None, 4])
def test_residual_vq_matches_jax(proj_dim):
    jrvq = JaxResidualVQ(num_quantizers=3, codebook_size=16, dim=8,
                         proj_dim=proj_dim)
    z = np.random.RandomState(1).randn(2, 10, 8).astype(np.float32)
    flat, tree = flax_params(jrvq, jnp.asarray(z), seed=2)
    (jq, jcodes, jcommit), jlook = jax.jit(
        lambda p, z_: (jrvq.apply(p, z_),
                       jrvq.apply(p, jrvq.apply(p, z_)[1],
                                  method=jrvq.lookup)))(tree, jnp.asarray(z))
    rvq = convert.load_flax_params(ResidualVQ(3, 16, 8, proj_dim), flat)
    with torch.no_grad():
        q, codes, commit = rvq(torch.from_numpy(z))
        look = rvq.lookup(codes)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(q.numpy(), jq, REL)
    _close(float(commit), float(jcommit), REL)
    _close(look.numpy(), jlook, REL)
    # the stage-0 distances leave no code at a tie here
    with torch.no_grad():
        r = rvq._norm(rvq.in0(torch.from_numpy(z))) if proj_dim \
            else torch.from_numpy(z)
        d = rvq.distances(r, rvq._codebook(0)).numpy()
    assert _margins(d).min() > TIE


@pytest.mark.parametrize("codec_type", ["soundstream", "encodec", "dac"])
def test_loss_codes_and_every_gradient(codec_type):
    kw = dict(SMALL, codec_type=codec_type, fs=8000)
    jmodel = JaxCodecModel(**kw)
    wav = _wave(3)
    flat, tree = _snake_alphas_near_one(
        flax_params(jmodel, jnp.asarray(wav), seed=4)[0])

    def loss_fn(p):
        loss, stats, _ = jmodel.apply(p, jnp.asarray(wav))
        return loss, stats

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree)
    jcodes, jdec = jax.jit(lambda p: (
        jmodel.apply(p, jnp.asarray(wav), method=jmodel.encode),
        jmodel.apply(p, jmodel.apply(p, jnp.asarray(wav),
                                     method=jmodel.encode),
                     method=jmodel.decode)))(tree)
    model = convert.load_flax_params(CodecModel(**kw), flat)
    with torch.no_grad():
        codes = model.encode(torch.from_numpy(wav))
        dec = model.decode(codes)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(dec.numpy(), jdec, REL)
    loss, stats, weight = model(torch.from_numpy(wav))
    loss.backward()
    assert weight == 2.0
    for k in ("loss", "recon_l1", "mel_l1", "commit"):
        _close(float(stats[k].detach()), float(jstats[k]), GRAD_REL)
    grads = convert.state_dict_to_flax(model, grad=True)
    jflat = {"params/" + "/".join(k): np.asarray(v)
             for k, v in flatten_dict(jgrads["params"]).items()}
    assert sorted(grads) == sorted(jflat)
    rel = GRAD_REL if codec_type == "soundstream" else MULTI_SCALE_REL
    top = max(float(np.abs(g).max()) for g in jflat.values())
    for name, g in jflat.items():
        err = float(np.abs(grads[name] - g).max())
        assert err <= rel * top, (name, err, top)


@pytest.fixture(scope="module")
def asset():
    jcoder = JaxCodecCoder(CODEC / "config.yaml", CODEC)
    coder = gan_codec_inference.CodecCoder(CODEC / "config.yaml", CODEC,
                                           device="cpu")
    return jcoder, coder


def test_asset_at_full_width(asset):
    """Two test utterances through the committed codec: the codes equal
    the JAX package's away from ties; the waves decoded from the JAX
    package's codes within 1e-4 of their largest sample."""
    jcoder, coder = asset
    corpus = SynthSpeechCorpus()
    w = np.zeros((2, 74656), np.float32)
    for i in range(2):
        u = corpus.utterance("test", i)[0][:74656]
        w[i, :len(u)] = u
    jm, jp = jcoder.model, jcoder.params
    jcodes, jdec = jax.jit(lambda p, x: (
        jm.apply(p, x, method=jm.encode),
        jm.apply(p, jm.apply(p, x, method=jm.encode), method=jm.decode)))(
            jp, jnp.asarray(w[:, :74560]))
    jcodes = np.asarray(jcodes)
    codes = coder.encode(w)
    assert codes.shape == (2, 233, 4)
    differ = codes != jcodes
    assert differ.mean() <= 1e-3, int(differ.sum())
    _close(coder.decode(jcodes), jdec, 1e-4)


def test_asset_converter_round_trip(asset):
    model = asset[1].model
    flat = load_checkpoint(CODEC)[0]
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(flat) and len(flat) == 23
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def _save_small(d):
    from espnet_tpu.tasks.ssl import CodecTask as JaxCodecTask
    d.mkdir(parents=True, exist_ok=True)
    cfg = {"fs": 8000, "codec_conf": dict(SMALL, strides=[2, 4])}
    dump_yaml(cfg, d / "config.yaml")
    flat, _ = flax_params(JaxCodecTask.build_model(cfg),
                          **JaxCodecTask.example_batch(cfg), seed=5)
    np.savez_compressed(d / "params_f16.npz",
                        **{k: v.astype(np.float16) for k, v in flat.items()})
    return cfg


def test_codec_coder_and_the_cli_match_jax(tmp_path):
    d = tmp_path / "model"
    _save_small(d)
    wav = _wave(6, B=1, n=1000)
    ours = gan_codec_inference.CodecCoder(d / "config.yaml", d,
                                          device="cpu")
    theirs = JaxCodecCoder(d / "config.yaml", d)
    codes = ours.encode(wav[0])
    np.testing.assert_array_equal(codes, theirs.encode(wav[0]))
    _close(ours.decode(codes), theirs.decode(codes), REL)
    from espnet_tpu_torch.data.fileio import read_wav, write_wav
    scp = tmp_path / "wav.scp"
    write_wav(tmp_path / "u0.wav", 8000, wav[0])
    scp.write_text(f"u0 {tmp_path / 'u0.wav'}\n")
    kw = dict(wav_scp=str(scp), train_config=str(d / "config.yaml"),
              model_file=str(d))
    gan_codec_inference.main([
        "--output_dir", str(tmp_path / "ours"), "--wav_scp", str(scp),
        "--train_config", str(d / "config.yaml"), "--model_file", str(d),
        "--device", "cpu"])
    jax_inference(tmp_path / "theirs", **kw)
    np.testing.assert_array_equal(
        np.load(tmp_path / "ours" / "codes" / "u0.npy"),
        np.load(tmp_path / "theirs" / "codes" / "u0.npy"))
    a = read_wav(tmp_path / "ours" / "wav" / "u0.wav")[1]
    b = read_wav(tmp_path / "theirs" / "wav" / "u0.wav")[1]
    assert np.abs(a - b).max() <= 1.0 / 32767


def test_entry_point_trains_checkpoints_and_resumes(tmp_path):
    """gan_codec_train on the small codec: two epochs in one run end
    bit-identical to one epoch and a resumed one."""
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=2,
                                    n_valid=1, n_test=0)
    data = tmp_path / "data"

    def run(name, max_epoch, resume=False):
        cfg = {"fs": 16000, "codec_conf": dict(SMALL),
               "output_dir": str(tmp_path / name), "max_epoch": max_epoch,
               "batch_type": "sorted", "batch_size": 2,
               "optim_conf": {"lr": 3e-4}, "num_iters_per_epoch": 1,
               "resume": resume, "device": "cpu",
               "collate_fixed_lengths": {"speech": 74656},
               "train_data_path_and_name_and_type": [
                   f"{data}/train/wav.scp,speech,sound"],
               "valid_data_path_and_name_and_type": [
                   f"{data}/valid/wav.scp,speech,sound"]}
        dump_yaml(cfg, tmp_path / f"{name}.yaml")
        return gan_codec_train.main(["--config",
                                     str(tmp_path / f"{name}.yaml")])

    _, trainer = run("a", 2)
    assert len(trainer.step_stats) == 2
    assert all(np.isfinite(s["loss"]) and s["mel_l1"] > 0
               for s in trainer.step_stats)
    run("b", 1)
    run("b", 2, resume=True)
    a = load_checkpoint(tmp_path / "a" / "checkpoint")[0]
    b = load_checkpoint(tmp_path / "b" / "checkpoint")[0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_task_builds_each_codec_type():
    for codec_type in ("soundstream", "encodec", "dac"):
        m = CodecTask.build_model({"codec_conf": dict(SMALL,
                                                      codec_type=codec_type)})
        assert m.codec_type == codec_type and m.hop == 8
    with pytest.raises(ValueError):
        CodecModel(codec_type="mimi")
