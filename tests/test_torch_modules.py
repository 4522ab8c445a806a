"""Each module of the port's ASR slice against its JAX counterpart, on the
CPU, at a small width (2 conformer blocks and 2 decoder layers, d=64),
with weights that fill the JAX model's parameter tree from a numpy seed
(``tests/torch_streaming_models.py:flax_params``), carried across by
``convert.py``.

Inputs are made with numpy from a seed and fed to both. Outputs are fp32
computed in a different order by the two frameworks; tolerances are a
few ulps of their magnitude (O(1) activations, O(10) logits).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode import ctc_prefix as jax_ctc_prefix
from espnet_tpu.decode.beam_search import \
    BeamSearchConfig as JaxBeamSearchConfig
from espnet_tpu.decode.beam_search import \
    batch_beam_search as jax_batch_beam_search
from espnet_tpu.decode.ctc_greedy import ctc_greedy_decode as jax_greedy
from espnet_tpu.frontends.default import DefaultFrontend as JaxFrontend
from espnet_tpu.nn.attention import RelPositionMultiHeadedAttention as JaxMHA
from espnet_tpu.nn.attention import rel_shift as jax_rel_shift
from espnet_tpu.nn.conformer import ConformerEncoderLayer as JaxLayer
from espnet_tpu.nn.conformer import ConvolutionModule as JaxConvModule
from espnet_tpu.nn.decoder import TransformerDecoder as JaxDecoder
from espnet_tpu.nn.embedding import PositionalEncoding as JaxPE
from espnet_tpu.nn.embedding import RelPositionalEncoding as JaxRelPE
from espnet_tpu.nn.subsampling import Conv2dSubsampling as JaxSubsampling
from espnet_tpu.nn.transformer import PositionwiseFeedForward as JaxFFN
from espnet_tpu.tasks.asr import ASRTask
from espnet_tpu.utils.masks import make_non_pad_mask as jax_valid_mask
from espnet_tpu_torch import convert
from espnet_tpu_torch.decode import ctc_prefix
from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batch_beam_search)
from espnet_tpu_torch.decode.ctc_greedy import ctc_greedy_decode
from espnet_tpu_torch.frontends.default import DefaultFrontend
from espnet_tpu_torch.nn.attention import rel_shift
from espnet_tpu_torch.nn.embedding import (PositionalEncoding,
                                           RelPositionalEncoding)
from espnet_tpu_torch.tasks.asr import build_model, read_token_list
from tests.torch_streaming_models import flax_params, xla_unoptimized

FLAGSHIP = (Path(__file__).resolve().parents[1] / "assets"
            / "synth_asr_flagship")
D = 64
ATOL = 1e-4


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


def _close(torch_out, jax_out, atol=ATOL):
    """Assert agreement; return the max abs error."""
    a, b = torch_out.detach().numpy(), np.asarray(jax_out)
    np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4)
    return float(np.abs(a - b).max())


@pytest.fixture
def parity(record_property):
    """_close that also records the max abs error in the test report."""
    def check(name, torch_out, jax_out, atol=ATOL):
        record_property(f"max_abs_err:{name}",
                        _close(torch_out, jax_out, atol))
    return check


@pytest.fixture(scope="module")
def small():
    cfg = {
        "token_list": read_token_list(FLAGSHIP / "tokens.txt"),
        "frontend": "default",
        "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
        "normalize": "global_mvn",
        "stats_file": str(FLAGSHIP / "feats_stats.npz"),
        "encoder": "conformer",
        "encoder_conf": {"output_size": D, "attention_heads": 4,
                         "linear_units": 128, "num_blocks": 2,
                         "cnn_module_kernel": 7},
        "decoder": "transformer",
        "decoder_conf": {"attention_heads": 4, "linear_units": 128,
                         "num_blocks": 2},
        "model_conf": {"ctc_weight": 0.3},
    }
    jmodel = ASRTask.build_model(cfg)
    # the JAX tree (eval_shape of its init: nothing compiled) filled at
    # init scale from a numpy seed, no bias zero and no scale one, so
    # that each layout mapping is exercised
    flat, params = flax_params(jmodel, **ASRTask.example_batch(cfg))
    tmodel = convert.load_flax_params(build_model(cfg), flat).eval()
    return jmodel, params, tmodel


def _jit(module, method):
    """module.apply(params, *args, method=method), compiled whole: faster
    than JAX's op-by-op dispatch."""
    return jax.jit(lambda params, *args: module.apply(params, *args,
                                                      method=method))


def _sub(params, *path):
    node = params["params"]
    for p in path:
        node = node[p]
    return {"params": node}


def _speech(rng, lens):
    x = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = 0.3 * rng.randn(n)
    return x, np.asarray(lens)


@torch.no_grad()
def test_frontend_and_global_mvn(small, parity):
    jmodel, params, tmodel = small
    x, lens = _speech(np.random.RandomState(1), [9000, 6100])
    feats, flens = jmodel.apply(
        params, jnp.asarray(x), jnp.asarray(lens),
        method=lambda m, s, l: m._normalize(*m._frontend(s, l)))
    tfeats, tflens = tmodel.normalize(*tmodel.frontend(_t(x), _t(lens)))
    np.testing.assert_array_equal(tflens.numpy(), np.asarray(flens))
    # normalised log-mel, |x| up to ~10
    parity("frontend+global_mvn", tfeats, feats, atol=1e-3)
    for use in ("never", "pallas"):
        f, fl = JaxFrontend(use_fused_kernel=use)(jnp.asarray(x),
                                                  jnp.asarray(lens))
        tf, tfl = DefaultFrontend(use_fused_kernel=use)(_t(x), _t(lens))
        np.testing.assert_array_equal(tfl.numpy(), np.asarray(fl))
        parity(f"frontend[{use}]", tf, f, atol=1e-3)


@torch.no_grad()
def test_positional_encodings():
    x = np.random.RandomState(2).randn(2, 9, D).astype(np.float32)
    jx, jpe = JaxRelPE(D).apply({}, jnp.asarray(x))
    # eval(): the encodings now carry dropout, off as in JAX's default
    tx, tpe = RelPositionalEncoding(D).eval()(_t(x))
    _close(tx, jx, atol=1e-5)
    _close(tpe, jpe, atol=1e-6)
    _close(PositionalEncoding(D).eval()(_t(x)),
           JaxPE(D).apply({}, jnp.asarray(x)),
           atol=1e-5)
    s = np.random.RandomState(3).randn(2, 3, 9, 17).astype(np.float32)
    np.testing.assert_array_equal(rel_shift(_t(s)).numpy(),
                                  np.asarray(jax_rel_shift(jnp.asarray(s))))


@torch.no_grad()
def test_subsampling(small, parity):
    _, params, tmodel = small
    x = np.random.RandomState(4).randn(2, 50, 80).astype(np.float32)
    lens = np.array([50, 33])
    h, olens = JaxSubsampling(D).apply(
        _sub(params, "encoder_mod", "embed"), jnp.asarray(x),
        jnp.asarray(lens))
    th, tolens = tmodel.encoder_mod.embed(_t(x), _t(lens))
    np.testing.assert_array_equal(tolens.numpy(), np.asarray(olens))
    parity("Conv2dSubsampling", th, h)


@torch.no_grad()
def test_conformer_block_and_its_parts(small, parity):
    _, params, tmodel = small
    rng = np.random.RandomState(5)
    x = rng.randn(2, 13, D).astype(np.float32)
    lens = np.array([13, 8])
    valid = np.asarray(jax_valid_mask(jnp.asarray(lens), 13))
    _, pos = JaxRelPE(D).apply({}, jnp.asarray(x))
    layer = tmodel.encoder_mod.layers[0]
    p = _sub(params, "encoder_mod", "layer0")
    tv, tpos = _t(valid), _t(pos)
    parity("RelPositionMultiHeadedAttention",
           layer.self_attn(_t(x), _t(x), _t(x), tpos, tv[:, None]),
           JaxMHA(4, D).apply(_sub(p, "self_attn"), *[jnp.asarray(x)] * 3,
                              pos, valid[:, None]))
    parity("PositionwiseFeedForward", layer.feed_forward(_t(x)),
           JaxFFN(128, activation="swish").apply(_sub(p, "feed_forward"),
                                                 jnp.asarray(x)))
    parity("ConvolutionModule", layer.conv_module(_t(x), tv),
           JaxConvModule(D, 7).apply(_sub(p, "conv_module"), jnp.asarray(x),
                                     valid))
    parity("ConformerEncoderLayer", layer(_t(x), tpos, tv[:, None], tv),
           JaxLayer(4, D, 128, 7).apply(p, jnp.asarray(x), pos,
                                        valid[:, None], valid))


@torch.no_grad()
def test_encoder_and_ctc_head(small, parity):
    jmodel, params, tmodel = small
    x, lens = _speech(np.random.RandomState(6), [7000, 4500])
    enc, enc_lens = _jit(jmodel, jmodel.encode)(params, jnp.asarray(x),
                                                jnp.asarray(lens))
    logits = _jit(jmodel, jmodel.ctc_logits)(params, enc)
    tenc, tenc_lens = tmodel.encode(_t(x), _t(lens))
    np.testing.assert_array_equal(tenc_lens.numpy(), np.asarray(enc_lens))
    parity("ConformerEncoder", tenc, enc)
    parity("CTCHead", tmodel.ctc_logits(tenc), logits)


@torch.no_grad()
def test_decoder_init_score_and_select(small, parity):
    jmodel, params, tmodel = small
    rng = np.random.RandomState(7)
    B, beam, Tenc, L = 2, 3, 11, 6
    mem = rng.randn(B, Tenc, D).astype(np.float32)
    mlens = np.array([11, 7])
    state = jmodel.apply(params, jnp.asarray(mem), jnp.asarray(mlens),
                         B * beam, L, method=jmodel.decoder_init_state)
    tstate = tmodel.decoder_init_state(_t(mem), _t(mlens), B * beam, L)
    _close(tstate["enc_k"], state["enc_k"])
    score_step = _jit(jmodel, jmodel.decoder_score_step)
    for step in range(4):
        tok = rng.randint(0, 25, size=B * beam)
        logp, state = score_step(params, jnp.asarray(tok), step, state)
        tlogp, tstate = tmodel.decoder_score_step(_t(tok), step, tstate)
        parity(f"TransformerDecoder.score_step[{step}]", tlogp, logp)
        # reorder rows within each utterance's beam block
        idx = np.concatenate([b * beam + rng.permutation(beam)
                              for b in range(B)])
        state = JaxDecoder.select_state(state, jnp.asarray(idx))
        tstate = tmodel.decoder_mod.select_state(tstate, _t(idx))
    _close(tstate["cache_k"], state["cache_k"])


def test_ctc_prefix_scorer(parity):
    rng = np.random.RandomState(8)
    rows, T, V, W = 4, 9, 7, 3
    logp = np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.randn(rows, T, V).astype(np.float32) * 2)))
    lens = np.array([9, 6, 9, 3])
    x = jax_ctc_prefix.pad_log_posteriors(jnp.asarray(logp),
                                          jnp.asarray(lens))
    tx = ctc_prefix.pad_log_posteriors(_t(logp), _t(lens))
    _close(tx, x, atol=0)
    st, tst = jax_ctc_prefix.init_state(x), ctc_prefix.init_state(tx)
    score = jax.jit(jax_ctc_prefix.score_candidates, static_argnums=(4, 5))
    select = jax.jit(jax_ctc_prefix.select_state)
    for _ in range(3):
        cand = np.stack([rng.choice(np.arange(V), W, replace=False)
                         for _ in range(rows)])
        out = score(st, jnp.asarray(cand), x, jnp.asarray(lens), 0, V - 1)
        tout = ctc_prefix.score_candidates(tst, _t(cand), tx, _t(lens), 0,
                                           V - 1)
        for a, b in zip(tout, out):
            _close(a, b, atol=1e-4)
        src, col = rng.randint(rows, size=rows), rng.randint(W, size=rows)
        tok = cand[src, col]
        st = select(st, out[2], out[3], out[1], jnp.asarray(src),
                    jnp.asarray(col), jnp.asarray(tok))
        tst = ctc_prefix.select_state(tst, tout[2], tout[3], tout[1],
                                      _t(src), _t(col), _t(tok))
        parity("ctc_prefix.score", tst.score, st.score, atol=1e-4)


def test_ctc_greedy():
    rng = np.random.RandomState(9)
    logits = rng.randn(3, 20, 6).astype(np.float32)
    logits[:, ::3, 0] += 3.0  # blanks
    lens = np.array([20, 13, 1])
    tokens, n = jax_greedy(jnp.asarray(logits), jnp.asarray(lens))
    ttokens, tn = ctc_greedy_decode(_t(logits), _t(lens))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n))
    np.testing.assert_array_equal(ttokens.numpy(), np.asarray(tokens))


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
def test_beam_search_matches_jax(small, ctc_weight):
    jmodel, params, tmodel = small
    x, lens = _speech(np.random.RandomState(10), [6000, 3000, 4500])
    enc, enc_lens = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lens),
                                 method=jmodel.encode)
    ref = jax_batch_beam_search(
        jmodel, params, enc, enc_lens,
        JaxBeamSearchConfig(beam_size=4, ctc_weight=ctc_weight, nbest=2))
    out = batch_beam_search(
        tmodel, _t(enc), _t(enc_lens).long(),
        BeamSearchConfig(beam_size=4, ctc_weight=ctc_weight, nbest=2))
    assert [[ids for ids, _ in h] for h in out] == \
        [[ids for ids, _ in h] for h in ref]
    np.testing.assert_allclose([s for h in out for _, s in h],
                               [s for h in ref for _, s in h], atol=1e-3)
