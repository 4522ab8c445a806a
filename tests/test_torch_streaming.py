"""The port's streaming path against the JAX package, on the CPU: the
incremental frontend and its window arithmetic, the streaming encoder's
step with carried state (per-row offsets, the end of the positional
table), the stream against the port's own full-utterance forward, the
folded and numel batch samplers, and the CTC-only streaming asset: its
weights, and one utterance streamed at full width. The decoding classes
and the CLI are in test_torch_streaming_decode.py and
test_torch_streaming_transducer.py.

Inputs are made with numpy from a seed and fed to both packages. Both
compute in fp32 with sums in another order; each tolerance says why.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import asr_inference_streaming as jax_streaming_bin
from espnet_tpu.data import batching as jax_batching
from espnet_tpu.frontends import streaming as jax_frontend
from espnet_tpu.nn import streaming_encoder as jax_encoder
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import asr_inference_streaming
from espnet_tpu_torch.data import batching
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.frontends import streaming as frontend
from espnet_tpu_torch.nn import streaming_encoder
from espnet_tpu_torch.tasks.asr import ASRTask, build_model
from espnet_tpu_torch.utils.config import load_yaml
from tests.torch_streaming_models import (ENC, flax_params, noise, pushes,
                                          xla_unoptimized)

ROOT = Path(__file__).resolve().parents[1]
STREAMING = ROOT / "assets" / "synth_asr_streaming"


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


# ---- the frontend ---------------------------------------------------------

def test_feature_extractor_matches_jax(record_property):
    # the assets' frontend; pushes of random sizes, one shorter than a
    # hop, and a final push shorter than a hop; windows popped after every
    # push as the decoders pop them (83 frames, advancing by 80)
    conf = {"n_fft": 512, "hop_length": 128, "n_mels": 80, "fs": 16000}
    window, advance = frontend.subsample_window(4, 20)
    hop = conf["hop_length"]
    rng = np.random.RandomState(0)
    sizes = [int(s) for s in rng.randint(1, window * hop, 6)]
    sizes[2] = hop // 3
    sizes.append(7)
    audio = noise(sum(sizes), 1)
    ours = frontend.StreamingFeatureExtractor(**conf, device="cpu")
    ref = jax_frontend.StreamingFeatureExtractor(**conf)
    err, n_windows, pos = 0.0, 0, 0
    for j, n in enumerate(sizes):
        final = j == len(sizes) - 1
        ours.push(audio[pos:pos + n], is_final=final)
        ref.push(audio[pos:pos + n], is_final=final)
        pos += n
        assert ours.feats.shape == ref.feats.shape
        err = max(err, float(np.abs(ours.feats - ref.feats).max(initial=0)))
        while True:
            a = ours.pop_one_window(window, advance, final, with_valid=True)
            b = ref.pop_one_window(window, advance, final, with_valid=True)
            assert (a is None) == (b is None)
            if a is None:
                break
            assert a[1] == b[1]
            err = max(err, float(np.abs(a[0] - b[0]).max()))
            n_windows += 1
    # log-mel of O(10) from a 512-term DFT in fp32, a matrix product
    # in torch and an einsum in XLA
    assert err <= 1e-4 and n_windows >= 2
    record_property("max_abs_err:stream_feats", err)


def test_window_arithmetic_matches_jax():
    for rate in (1, 2, 4, 6, 8):
        assert (frontend.subsample_window(rate, 20)
                == jax_frontend.subsample_window(rate, 20))
        for n in range(201):
            assert (frontend.subsampled_valid_len(rate, n)
                    == jax_frontend.subsampled_valid_len(rate, n)), (rate, n)


# ---- the encoder step -----------------------------------------------------

def _state_np(state):
    return [np.asarray(x) for x in state]


@pytest.mark.parametrize("input_layer", ["conv2d", "conv2d2"])
def test_encoder_step_matches_jax(input_layer, record_property):
    # two rows stepped over 6 chunks with carried state from zeros; then
    # from a state with other offsets per row, and from one near the end
    # of the 8192-row positional table, where the JAX package's gather
    # clamps to the last row
    conf = dict(ENC, input_layer=input_layer, dropout_rate=0.0)
    rate = {"conv2d": 4, "conv2d2": 2}[input_layer]
    W, _ = frontend.subsample_window(rate, conf["chunk_size"])
    rng = np.random.RandomState(3)
    jenc = jax_encoder.StreamingConformerEncoder(input_size=20, **conf)
    flat, params = flax_params(jenc, jnp.zeros((2, W, 20)),
                               jnp.asarray([W, W]))
    enc = convert.load_flax_params(
        streaming_encoder.StreamingConformerEncoder(20, **conf), flat).eval()
    jstep = jax.jit(lambda p, f, st: jenc.apply(p, f, st,
                                                method=jenc.stream_step))
    L = conf["chunk_size"] * conf["left_chunks"]
    starts = {
        "zeros": None,
        "offsets": np.array([3, 9]),
        "table_end": np.array([8190, 8181]),
    }
    err = 0.0
    for name, offsets in starts.items():
        if offsets is None:
            jst = jenc.apply(params, 2, method=jenc.init_stream_state)
        else:
            shape = (2, 2, L, 32)
            jst = jax_encoder.StreamingState(
                ctx=jnp.asarray(rng.randn(*shape).astype(np.float32)),
                conv_tail=jnp.asarray(rng.randn(2, 2, 4, 32)
                                      .astype(np.float32)),
                frame_offset=jnp.asarray(offsets, jnp.int32))
        st = streaming_encoder.StreamingState(
            *(_t(np.asarray(x)) for x in jst))
        st = st._replace(frame_offset=st.frame_offset.long())
        for c in range(6 if offsets is None else 2):
            feats = rng.randn(2, W, 20).astype(np.float32)
            ref, jst = jstep(params, jnp.asarray(feats), jst)
            with torch.no_grad():
                ours, st = enc.stream_step(_t(feats), st)
            # two blocks, LayerNorm-ed outputs O(1); the carried context
            # and tails are sums of O(1) terms
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       atol=1e-5, rtol=0, err_msg=name)
            for a, b in zip(_state_np(st), _state_np(jst)):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                           err_msg=name)
            err = max(err, float(np.abs(ours.numpy() - ref).max()))
        if name == "table_end":
            assert st.frame_offset.tolist() == [8198, 8189]
    record_property("max_abs_err:encoder_step", err)


def test_stream_equals_the_full_chunked_forward():
    # the port's own stream against its full-utterance forward under the
    # chunk mask, with the linear input layer, where the JAX package's
    # tests/test_streaming.py asserts the same of the JAX package
    conf = dict(ENC, output_size=16, linear_units=32, input_layer="linear",
                dropout_rate=0.0)
    torch.manual_seed(0)
    enc = streaming_encoder.StreamingConformerEncoder(6, **conf).eval()
    for p in enc.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = _t(np.random.RandomState(0).randn(1, 16, 6).astype(np.float32))
    with torch.no_grad():
        full, _ = enc(x, torch.tensor([16]))
        state = enc.init_stream_state(1)
        outs = []
        for c in range(4):
            out, state = enc.stream_step(x[:, 4 * c:4 * c + 4], state)
            outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=2e-4, rtol=0)


# ---- batching -------------------------------------------------------------

@pytest.mark.parametrize("batch_type", ["folded", "numel"])
def test_batch_samplers_match_jax(batch_type):
    rng = np.random.RandomState(11)
    keys = [f"utt{i:03d}" for i in range(97)]
    shapes = [{k: int(n) for k, n in zip(keys, rng.randint(2000, 200000,
                                                           97))},
              {k: int(n) for k, n in zip(keys, rng.randint(5, 90, 97))}]
    for kw in ({"batch_size": 8, "batch_bins": 600000, "fold_length": 50000},
               {"batch_size": 20, "batch_bins": 1000000,
                "fold_length": 80000, "min_batch_size": 3,
                "drop_last": True}):
        ours = batching.build_batch_sampler(batch_type, utt2shapes=shapes,
                                            keys=keys, **kw)
        ref = jax_batching.build_batch_sampler(batch_type, utt2shapes=shapes,
                                               keys=keys, **kw)
        assert ours == ref and len(ours) > 3


def test_streaming_asset_config_builds_numel_batches(tmp_path):
    SynthSpeechCorpus().materialize(tmp_path, n_train=5, n_valid=0,
                                    n_test=0)
    cfg = {**ASRTask.default_config(), **load_yaml(
        STREAMING / "config.yaml"),
        "train_data_path_and_name_and_type": [
            f"{tmp_path}/train/wav.scp,speech,sound",
            f"{tmp_path}/train/text,text,text"],
        "token_list": str(STREAMING / "tokens.txt"), "batch_bins": 150000}
    assert cfg["batch_type"] == "numel"
    batches = ASRTask.build_iter_factory(cfg, train=True).epoch_batches(0)
    assert sorted(k for b in batches for k in b) == [
        f"train_{i:05d}" for i in range(5)]
    assert 1 < len(batches) < 5


# ---- the CTC-only streaming asset, at full width --------------------------

def test_streaming_asset_weights_round_trip():
    flat = convert.read_npz(STREAMING / "params_f16.npz")
    cfg = load_yaml(STREAMING / "config.yaml")
    cfg.update(token_list=str(STREAMING / "tokens.txt"),
               stats_file=str(STREAMING / "feats_stats.npz"))
    model = build_model(cfg)
    assert model.decoder_mod is None and len(flat) == 214
    # load_flax_params raises on a missing or an unused key
    convert.load_flax_params(model, flat)
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_streaming_asset_one_utterance_matches_jax(record_property):
    # valid utterance 0 pushed in 640 ms pieces: the port's
    # Speech2TextStreaming (greedy) against the JAX class's own encoder
    # steps (_encode_pending) on the same windows, with its CTC head's
    # argmax, blanks and repeats dropped
    wave, _, _ = SynthSpeechCorpus().utterance("valid", 0)
    kw = dict(asr_train_config=STREAMING / "config.yaml",
              asr_model_file=STREAMING)
    ref = jax_streaming_bin.Speech2TextStreaming(**kw)
    ours = asr_inference_streaming.Speech2TextStreaming(**kw, device="cpu")
    for piece, final in pushes(wave, 10240):
        ids = ours(piece, is_final=final)[0][2]
    with torch.no_grad():
        for s2t in (ours, ref):      # the final push above reset ``ours``
            for piece, final in pushes(wave, 10240):
                s2t.fe.push(piece, is_final=final)
                s2t._encode_pending(final)
    assert len(ours._enc_chunks) == len(ref._enc_chunks) >= 3
    enc = torch.cat(ours._enc_chunks).numpy()
    jenc = np.concatenate(ref._enc_chunks)
    head = ref.params["params"]["ctc"]["ctc_lo"]
    jtoks = (jenc @ np.asarray(head["kernel"])
             + np.asarray(head["bias"])).argmax(-1)
    jids = [int(t) for i, t in enumerate(jtoks)
            if t != 0 and (i == 0 or t != jtoks[i - 1])]
    assert ids == jids and len(ids) > 10
    # 6 blocks at d = 256 in fp32: within 1e-4 of the largest entry, as
    # the long-form model's log-probabilities are held
    err = float(np.abs(enc - jenc).max())
    assert enc.shape == jenc.shape and err <= 1e-4 * np.abs(jenc).max()
    record_property("max_abs_err:asset_stream_enc", err)
